"""The port's batched-dot op (``ops/bdot.py``) against the JAX package's
Pallas probe kernel ``scripts/probe_bdot.py::pallas_bdot`` and float64.

The probe script runs its TPU timing loop at module level, so the test
parses it and executes only the ``pallas_bdot`` definition, with
``pl.pallas_call`` in interpret mode (how the JAX package's own tests run
its Pallas kernels on the CPU). On the CPU ``bdot`` runs its plain torch
version; the CUDA kernel is compared with it in the tests marked
``cuda`` (they skip where no GPU is present)."""

import ast
import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from safer2_recommender_tpu_torch.ops import bdot as tbd

PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "probe_bdot.py")
SCALE = 1e-2


@pytest.fixture(scope="module")
def pallas_bdot():
    """``pallas_bdot`` from the probe script, its Pallas call
    interpreted."""
    with open(PROBE) as f:
        tree = ast.parse(f.read(), PROBE)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "pallas_bdot")
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    ns = {"jax": jax, "jnp": jnp, "pl": interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), PROBE, "exec"), ns)
    return ns["pallas_bdot"]


def _x(h, n=16, seed=0):
    rng = np.random.default_rng(seed + h)
    return (rng.normal(size=(n, h, h)) * 0.1).astype(np.float32)


def _chain64(x, n_dots):
    acc = x.astype(np.float64)
    for _ in range(n_dots):
        acc = np.matmul(acc, x.astype(np.float64)) * SCALE
    return acc


def _power64(x, n_dots):
    return (np.linalg.matrix_power(x.astype(np.float64), n_dots + 1)
            * SCALE ** n_dots)


def _rel(y, want):
    return np.abs(y - want).max() / np.abs(want).max()


@pytest.mark.parametrize("h, n_dots", [
    pytest.param(h, n, id=str(h) if n == 3 else f"{h}-dots{n}")
    for h in (32, 64, 128) for n in (1, 3, 8)])
def test_bdot_matches_pallas_probe_and_float64(pallas_bdot, h, n_dots):
    x = _x(h)
    want = _chain64(x, n_dots)
    jgot = np.asarray(pallas_bdot(jnp.asarray(x), 8, n_dots,
                                  jax.lax.Precision.HIGHEST))
    ref = tbd.bdot_ref(torch.from_numpy(x), n_dots, SCALE).numpy()
    got = tbd.bdot(torch.from_numpy(x), n_dots, SCALE).numpy()
    # The plain version squares (x^9 in 4 products, not the chain's 8),
    # so its rounding order differs from the Pallas chain's and the two
    # are held to the float64 chain, not to each other: f32 products of
    # depth <= 128 stay within ~16 ulps (6e-8 each) of the largest entry
    # (measured <= 7.7e-7 at h <= 128 and n_dots <= 13)
    for name, y in (("pallas", jgot), ("plain", ref), ("bdot", got)):
        assert _rel(y, want) <= 2e-6, name
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h", [32, 128])
def test_bdot_places_the_scale_like_the_chain(h):
    # x^(n+1) * s^n for every n_dots up to 13 (m = 14: 5 products)
    x = _x(h, n=4)
    for n_dots in range(14):
        got = tbd.bdot(torch.from_numpy(x), n_dots, SCALE).numpy()
        assert _rel(got, _power64(x, n_dots)) <= 2e-6, n_dots


@pytest.mark.parametrize("value, want", [
    (1 + 2 ** -11, 1 + 2 ** -10),     # the tie rounds away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 2 ** -12, 1.0),              # below the tie: to nearest
    (1 + 3 * 2 ** -12, 1 + 2 ** -10),  # above the tie
    (0.0, 0.0),
])
def test_round_tf32_is_cvt_rna(value, want):
    got = tbd.round_tf32(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == want


def test_round_tf32_clears_the_low_13_bits():
    x = torch.from_numpy(_x(32, n=2))
    bits = tbd.round_tf32(x).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float((tbd.round_tf32(x) - x).abs().max()
                 / x.abs().max()) <= 2 ** -11


@pytest.mark.parametrize("n_dots", [1, 8, 13])
@pytest.mark.parametrize("h", [32, 64, 128])
def test_default_precision_is_one_tf32_pass(h, n_dots):
    # JAX's DEFAULT precision on the CPU is full f32, so the Pallas probe
    # is not compared here: TF32 operands (11 significant bits) hold the
    # result within ~2^-10 of max|float64| (measured <= 1.03e-3)
    x = _x(h)
    got = tbd.bdot(torch.from_numpy(x), n_dots, SCALE, "default").numpy()
    ref = tbd.bdot_ref(torch.from_numpy(x), n_dots, SCALE, "default")
    np.testing.assert_array_equal(got, ref.numpy())
    assert _rel(got, _chain64(x, n_dots)) <= 1e-2
    # the operands were rounded: not the f32 result
    assert not np.array_equal(got, tbd.bdot(torch.from_numpy(x), n_dots,
                                            SCALE).numpy())


def test_bdot_zero_dots_is_a_copy():
    x = torch.from_numpy(_x(32, n=3))
    got = tbd.bdot(x, 0)
    assert torch.equal(got, x) and got.data_ptr() != x.data_ptr()


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    before = tbd.LAUNCHES
    tbd.bdot(torch.from_numpy(_x(64, n=4)), 2)
    assert tbd.LAUNCHES == before


@pytest.mark.parametrize("case", [
    "h_not_supported", "not_square", "not_3d", "float64", "not_contiguous",
    "negative_dots", "float_dots", "precision_unknown", "precision_upper",
    "precision_not_a_string"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    x, n_dots = torch.zeros(4, 32, 32), 2
    if case == "h_not_supported":
        x = torch.zeros(4, 48, 48)
    elif case == "not_square":
        x = torch.zeros(4, 32, 64)
    elif case == "not_3d":
        x = torch.zeros(32, 32)
    elif case == "float64":
        x = x.double()
    elif case == "not_contiguous":
        x = torch.zeros(32, 4, 32).transpose(0, 1)
    elif case == "negative_dots":
        n_dots = -1
    elif case == "float_dots":
        n_dots = 2.0
    precision = {"precision_unknown": "high", "precision_upper": "HIGHEST",
                 "precision_not_a_string": 3}.get(case, "highest")
    with pytest.raises((ValueError, TypeError)):
        tbd.bdot(x, n_dots, precision=precision)


@pytest.mark.cuda
@pytest.mark.parametrize("h, precision", [
    pytest.param(h, p, id=str(h) if p == "highest" else f"{h}-{p}")
    for h in (32, 64, 128) for p in ("highest", "default")])
def test_kernel_matches_plain_on_cuda(h, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    for n, n_dots in ((4096, 8), (4097, 13), (1, 13), (2, 0)):
        x = torch.from_numpy(_x(h, n=n)).cuda()
        before = tbd.LAUNCHES
        got = tbd.bdot(x, n_dots, precision=precision)
        want = tbd.bdot_ref(x, n_dots, precision=precision)
        torch.cuda.synchronize()
        assert tbd.LAUNCHES == before + 1
        # the f32 summation order differs from cuBLAS's; at "default" a
        # last-bit difference flips a rounding to TF32 (two plain versions
        # of the same TF32 arithmetic differ by up to 2.5e-4,
        # probes/bdot_design.py)
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= (1e-4 if precision == "highest" else 1e-3), (
            n, n_dots, rel)
        if precision == "highest":
            assert _rel(got.cpu().numpy(),
                        _power64(x.cpu().numpy(), n_dots)) <= 1e-5


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_input_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    flat = torch.from_numpy(_x(64, n=3)).cuda().reshape(-1)
    x = torch.cat([flat[:1], flat])[1:].view(3, 64, 64)   # 4 bytes off
    assert x.data_ptr() % 16
    got = tbd.bdot(x, 8)
    want = tbd.bdot_ref(x, 8)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
