"""The port's batched-dot op (``ops/bdot.py``) against the JAX package's
Pallas probe kernel ``scripts/probe_bdot.py::pallas_bdot`` and float64.

The probe script runs its TPU timing loop at module level, so the test
parses it and executes only the ``pallas_bdot`` definition, with
``pl.pallas_call`` in interpret mode (how the JAX package's own tests run
its Pallas kernels on the CPU). On the CPU ``bdot`` runs its plain torch
version; the CUDA kernel is compared with it in
``test_kernel_matches_plain_on_cuda`` (marked ``cuda``; it skips where no
GPU is present)."""

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


@pytest.mark.parametrize("h", [32, 64, 128])
def test_bdot_matches_pallas_probe_and_float64(pallas_bdot, h):
    x = _x(h)
    want = _chain64(x, 3)
    jgot = np.asarray(pallas_bdot(jnp.asarray(x), 8, 3,
                                  jax.lax.Precision.HIGHEST))
    ref = tbd.bdot_ref(torch.from_numpy(x), 3, SCALE).numpy()
    got = tbd.bdot(torch.from_numpy(x), 3, SCALE).numpy()
    scale = np.abs(want).max()
    # three chained f32 products of depth <= 128 round to within ~8
    # ulps (6e-8 each) of the largest entry (measured <= 5e-7)
    for name, y in (("pallas", jgot), ("plain", ref), ("bdot", got)):
        assert np.abs(y - want).max() / scale <= 1e-6, name
    # the same f32 products in the same order as the interpreted Pallas
    # kernel: equal to within 2 ulps (measured equal)
    assert np.abs(got - jgot).max() / scale <= 1.2e-7
    np.testing.assert_array_equal(got, ref)


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
    "negative_dots", "float_dots"])
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
    else:
        n_dots = 2.0
    with pytest.raises((ValueError, TypeError)):
        tbd.bdot(x, n_dots)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 64, 128])
def test_kernel_matches_plain_on_cuda(h):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    x = torch.from_numpy(_x(h, n=4096)).cuda()
    before = tbd.LAUNCHES
    got = tbd.bdot(x, 8)
    want = tbd.bdot_ref(x, 8)
    torch.cuda.synchronize()
    assert tbd.LAUNCHES == before + 1
    # the f32 summation order differs from cuBLAS's
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
