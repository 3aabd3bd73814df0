"""The port's batched SPD solver against the JAX package's and numpy.

On the CPU ``chol_inverse_small`` runs its plain torch version; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_ops.py
does. The CUDA kernel itself is compared with the plain version in the
tests marked ``cuda`` (they skip where no GPU is present): at every r,
at the ragged N, on the hard systems and on an unaligned input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from safer2_recommender_tpu.ops import block_chol as jbc
from safer2_recommender_tpu_torch.ops import block_chol as tbc

# the JAX package's own spd_solve bounds (tests/test_ops.py)
RTOL, ATOL = 2e-3, 2e-4


def _random_spd(rng, n, d):
    m = rng.normal(size=(n, d, d)).astype(np.float32)
    return m @ m.transpose(0, 2, 1) + 0.5 * np.eye(d, dtype=np.float32)


def _well_conditioned(rng, n, r):
    x = rng.normal(size=(n, r, 2 * r)).astype(np.float32)
    a = x @ x.transpose(0, 2, 1) / (2 * r) + 0.1 * np.eye(r, dtype=np.float32)
    ridge = rng.uniform(0.01, 0.5, size=(n, r)).astype(np.float32)
    return a, ridge


@pytest.fixture()
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("FRT_PALLAS_INTERPRET", "1")
    jbc.chol_inverse.clear_cache()
    jbc.spd_solve.clear_cache()
    yield
    jbc.chol_inverse.clear_cache()
    jbc.spd_solve.clear_cache()


def _jax_solve(a, b, ridge=None):
    r = None if ridge is None else jnp.asarray(ridge)
    return np.asarray(jbc.spd_solve(jnp.asarray(a), jnp.asarray(b), r))


def _port_solve(a, b, ridge=None):
    r = None if ridge is None else torch.from_numpy(ridge)
    return tbc.spd_solve(torch.from_numpy(a), torch.from_numpy(b),
                         r).numpy()


@pytest.mark.parametrize("r", [8, 32, 64])
def test_plain_chol_inverse_matches_pallas_leaf(r, pallas_interpret):
    # r <= 32 is _leaf_kernel alone; r = 64 adds the _lane_matmul
    # recursion, which the port's column loop replaces
    rng = np.random.default_rng(r)
    a, ridge = _well_conditioned(rng, 16, r)
    want = np.asarray(jbc.chol_inverse(jnp.asarray(a), jnp.asarray(ridge)))
    got = tbc.chol_inverse_small_ref(torch.from_numpy(a),
                                     torch.from_numpy(ridge)).numpy()
    scale = np.abs(want).max(axis=(1, 2))
    rel = np.abs(got - want).max(axis=(1, 2)) / scale
    assert rel.max() <= 1e-4
    iu = np.triu_indices(r, k=1)
    assert (got[:, iu[0], iu[1]] == 0.0).all()


@pytest.mark.parametrize("d", [1, 2, 5, 8, 16, 24, 32, 96, 128, 256])
def test_spd_solve_matches_jax_and_numpy(d):
    rng = np.random.default_rng(d)
    a = _random_spd(rng, 17, d)
    b = rng.normal(size=(17, d)).astype(np.float32)
    got = _port_solve(a, b)
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax_solve(a, b), rtol=RTOL, atol=ATOL)


def test_spd_solve_zero_rows_stay_finite():
    rng = np.random.default_rng(0)
    a = _random_spd(rng, 8, 16)
    a[3] = 0.0  # padded row: all-zero system
    b = rng.normal(size=(8, 16)).astype(np.float32)
    got = _port_solve(a, b)
    assert np.isfinite(got).all()
    # an all-zero system with a NONZERO rhs is degenerate: even the JAX
    # package's LAPACK and blocked dispatches disagree on it, so that
    # row is held to finiteness only
    keep = np.arange(8) != 3
    want = np.linalg.solve(a[keep], b[keep, :, None])[..., 0]
    np.testing.assert_allclose(got[keep], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[keep], _jax_solve(a, b)[keep],
                               rtol=RTOL, atol=ATOL)
    # a zero rhs (how padded rows arrive) gets the identity bump: x = 0
    b[3] = 0.0
    assert (_port_solve(a, b)[3] == 0.0).all()


@pytest.mark.parametrize("d", [16, 128])
def test_spd_solve_rank_deficient_stays_finite(d):
    # l2_reg=0 with history L < dim: singular PSD with a nonzero diagonal
    rng = np.random.default_rng(2)
    v = rng.normal(size=(6, 3, d)).astype(np.float32)
    a = np.einsum("nld,nle->nde", v, v)
    b = v.sum(1)
    assert np.isfinite(_port_solve(a, b)).all()


@pytest.mark.parametrize("kind", ["none", "per_system", "per_diagonal"])
@pytest.mark.parametrize("d", [16, 128])
def test_spd_solve_ridge_forms_match_explicit(kind, d):
    rng = np.random.default_rng(7)
    a = _random_spd(rng, 9, d)
    b = rng.normal(size=(9, d)).astype(np.float32)
    if kind == "none":
        ridge, diag = None, np.zeros((9, d), np.float32)
    elif kind == "per_system":
        ridge = rng.uniform(0.01, 0.5, 9).astype(np.float32)
        diag = np.repeat(ridge[:, None], d, axis=1)
    else:
        ridge = rng.uniform(0.01, 0.5, (9, d)).astype(np.float32)
        diag = ridge
    got = _port_solve(a, b, ridge)
    aa = a + diag[:, :, None] * np.eye(d, dtype=np.float32)
    want = np.linalg.solve(aa, b[..., None])[..., 0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax_solve(a, b, ridge),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("r", [8, 64])
def test_plain_chol_inverse_reads_the_lower_triangle_only(r):
    # the kernel reads only the lower triangle of a (its systems come
    # from products that need not be bit-symmetric); the plain version
    # it is held against must do the same
    rng = np.random.default_rng(30 + r)
    a, ridge = _well_conditioned(rng, 6, r)
    noisy = a + np.triu(rng.normal(size=(6, r, r)), 1).astype(np.float32)
    got = tbc.chol_inverse_small_ref(torch.from_numpy(noisy),
                                     torch.from_numpy(ridge))
    want = tbc.chol_inverse_small_ref(torch.from_numpy(a),
                                      torch.from_numpy(ridge))
    assert torch.equal(got, want)


def test_cpu_wrapper_runs_the_plain_version_without_counting():
    rng = np.random.default_rng(4)
    a, ridge = _well_conditioned(rng, 5, 16)
    before = dict(tbc.LAUNCHES)
    got = tbc.chol_inverse_small(torch.from_numpy(a), torch.from_numpy(ridge))
    want = tbc.chol_inverse_small_ref(torch.from_numpy(a),
                                      torch.from_numpy(ridge))
    assert torch.equal(got, want)
    assert tbc.LAUNCHES == before


@pytest.mark.parametrize("case", [
    "r_not_supported", "not_square", "float64", "ridge_shape",
    "not_contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a = torch.eye(16).repeat(4, 1, 1)
    ridge = torch.zeros(4, 16)
    if case == "r_not_supported":
        a, ridge = torch.eye(12).repeat(4, 1, 1), torch.zeros(4, 12)
    elif case == "not_square":
        a = torch.zeros(4, 16, 8)
    elif case == "float64":
        a = a.double()
    elif case == "ridge_shape":
        ridge = torch.zeros(4)
    else:
        a = a.transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        tbc.chol_inverse_small(a, ridge)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 16, 32, 64])
def test_kernel_matches_plain_on_cuda(r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    rng = np.random.default_rng(r)
    a, ridge = _well_conditioned(rng, 4096, r)
    a, ridge = torch.from_numpy(a).cuda(), torch.from_numpy(ridge).cuda()
    before = tbc.LAUNCHES[r]
    got = tbc.chol_inverse_small(a, ridge)
    want = tbc.chol_inverse_small_ref(a, ridge)
    torch.cuda.synchronize()
    assert tbc.LAUNCHES[r] == before + 1
    rel = ((got - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)))
    assert float(rel.max()) <= 1e-4


def _hard_systems(rng, n, r):
    """Well-conditioned systems with system 0 all zero under a unit
    ridge and system 1 of rank r/2 under ridge 1e-2."""
    a, ridge = _well_conditioned(rng, n, r)
    if n > 0:
        a[0], ridge[0] = 0.0, 1.0
    if n > 1:
        y = rng.normal(size=(r, r // 2)).astype(np.float32)
        a[1], ridge[1] = y @ y.T / r, 1e-2
    return a, ridge


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 16, 32, 64])
def test_kernel_ragged_and_hard_cases_on_cuda(r):
    # N = 0, 1, one block's systems +/- 1 (128 / r lane groups for
    # r <= 32, one system per block at 64) and 4097: the ragged tail is
    # masked; the zero system gives the identity, the rank-deficient one
    # stays within 1e-3, and nothing above the diagonal is nonzero
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    rng = np.random.default_rng(100 + r)
    per_block = 128 // r if r <= 32 else 1
    upper = torch.triu(torch.ones(r, r, dtype=torch.bool), 1).cuda()
    eye = torch.eye(r).cuda()
    for n in sorted({0, 1, max(per_block - 1, 0), per_block + 1, 4097}):
        a, ridge = _hard_systems(rng, n, r)
        a, ridge = torch.from_numpy(a).cuda(), torch.from_numpy(ridge).cuda()
        got = tbc.chol_inverse_small(a, ridge)
        want = tbc.chol_inverse_small_ref(a, ridge)
        torch.cuda.synchronize()
        assert got.shape == (n, r, r)
        if n == 0:
            continue
        assert bool(torch.isfinite(got).all()), n
        assert bool((got[:, upper] == 0).all()), n
        assert float((got[0] - eye).abs().max()) <= 1e-6, n
        rel = ((got - want).abs().amax(dim=(1, 2))
               / want.abs().amax(dim=(1, 2)))
        if n > 1:
            assert float(rel[1]) <= 1e-3, n
        if n > 2:
            assert float(rel[2:].max()) <= 1e-4, n


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_input_on_cuda():
    # the kernel reads rows as float4: an input that starts 4 bytes into
    # its storage is copied to an aligned one first, not refused
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    rng = np.random.default_rng(7)
    a, ridge = _well_conditioned(rng, 33, 16)
    flat = torch.from_numpy(np.concatenate([[0.0], a.ravel()])
                            .astype(np.float32)).cuda()
    a_off = flat[1:].view(33, 16, 16)
    assert a_off.data_ptr() % 16 != 0 and a_off.is_contiguous()
    ridge = torch.from_numpy(ridge).cuda()
    got = tbc.chol_inverse_small(a_off, ridge)
    want = tbc.chol_inverse_small_ref(a_off, ridge)
    torch.cuda.synchronize()
    rel = ((got - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)))
    assert float(rel.max()) <= 1e-4
