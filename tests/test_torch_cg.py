"""The port's conjugate-gradient solve (``--use_cg``, reference
ials.h:133-138) against the JAX package's ``cg_solve`` and the direct
solve, its fixed-trip form, and the CG epochs of the exact models
(SAFER2, iALS, ERM-MF) against their direct epochs and the JAX
package's CG epochs, on the CPU. Bounds are stated at each check."""

import os

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.ops import solve as jsolve
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, Server, get_model,
                                          interop)
from safer2_recommender_tpu_torch.ops import block_chol, solve

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))

EXACT = ("safer2", "ials", "erm_mf")
MODEL_CFG = {
    "safer2": dict(uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                   bandwidth=0.15),
    "ials": dict(uobs_weight=0.1, l2_reg=0.003),
    "erm_mf": dict(uobs_weight=0.004, l2_reg=0.005, alpha=0.3),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_spd(rng, n, d):
    # tests/test_ops.py::_random_spd
    m = rng.normal(size=(n, d, d)).astype(np.float32)
    return m @ m.transpose(0, 2, 1) + 0.5 * np.eye(d, dtype=np.float32)


def _ridge(kind, rng, n, d):
    if kind == "none":
        return None
    if kind == "scalar":
        return rng.uniform(0.1, 1.0, n).astype(np.float32)
    return rng.uniform(0.1, 1.0, (n, d)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ridge", ["none", "scalar", "vector"])
def test_cg_solve_matches_jax_and_the_direct_solve(ridge):
    # tests/test_ops.py::test_cg_solve_matches_cholesky on the port, with
    # the ridge absent, one per system ([N]) and a full diagonal ([N, d])
    rng = np.random.default_rng(1)
    a = _random_spd(rng, 8, 10)
    b = rng.normal(size=(8, 10)).astype(np.float32)
    rg = _ridge(ridge, rng, 8, 10)
    got = solve.cg_solve(_t(a), _t(b), max_iters=50, ridge=_t(rg)).numpy()
    want = np.asarray(jsolve.cg_solve(a, b, max_iters=50, ridge=rg))
    # the same iteration in f32: bound of the JAX epoch tests
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    shift = 0.0 if rg is None else (rg[:, :, None] * np.eye(10) if
                                    rg.ndim == 2 else
                                    rg[:, None, None] * np.eye(10))
    exact = np.linalg.solve((a + shift).astype(np.float64),
                            b[..., None].astype(np.float64))[..., 0]
    # tests/test_ops.py's CG-vs-direct bound
    np.testing.assert_allclose(got, exact, rtol=1e-2, atol=1e-3)
    direct = block_chol.spd_solve(_t(a), _t(b), _t(rg)).numpy()
    np.testing.assert_allclose(got, direct, rtol=1e-2, atol=1e-3)
    # use_cg=True routes to it; the default to the direct solve
    np.testing.assert_array_equal(
        solve.solve(_t(a), _t(b), use_cg=True, max_iters=50,
                    ridge=_t(rg)).numpy(), got)
    np.testing.assert_array_equal(
        solve.solve(_t(a), _t(b), ridge=_t(rg)).numpy(), direct)


@pytest.mark.parametrize("tol", [1e-10, 1e-3])
def test_fixed_trips_equal_the_early_exit_bit_for_bit(tol, monkeypatch):
    # the Server's captured fold-in runs every iteration (no host read is
    # allowed in a CUDA graph; the capture is faked here); a converged
    # system is frozen, so the extra iterations change nothing. At tol
    # 1e-3 most systems converge early, at different iterations, and the
    # batch exits early; padded (all-zero) systems are frozen from the
    # start
    rng = np.random.default_rng(4)
    a = _random_spd(rng, 40, 16)
    b = rng.normal(size=(40, 16)).astype(np.float32)
    a[[3, 17]] = 0.0
    b[[3, 17]] = 0.0
    rg = rng.uniform(0.1, 1.0, 40).astype(np.float32)
    rg[[3, 17]] = 0.0
    calls = []
    bmm = torch.bmm

    def counting(*args):
        calls.append(1)
        return bmm(*args)

    torch.bmm = counting
    try:
        early = solve.cg_solve(_t(a), _t(b), tol=tol, max_iters=100,
                               ridge=_t(rg))
        n_early = len(calls)
        monkeypatch.setattr(solve, "_capturing", lambda x: True)
        fixed = solve.cg_solve(_t(a), _t(b), tol=tol, max_iters=100,
                               ridge=_t(rg))
    finally:
        torch.bmm = bmm
    assert len(calls) - n_early == 100
    if tol == 1e-3:
        assert n_early < 100            # the batch did exit early
    assert torch.equal(early, fixed)
    assert bool((fixed[[3, 17]] == 0).all())
    if tol == 1e-10:
        want = np.asarray(jsolve.cg_solve(a, b, tol=tol, max_iters=100,
                                          ridge=rg))
        np.testing.assert_allclose(fixed.numpy(), want, rtol=2e-4,
                                   atol=2e-5)
    else:
        # the packages may stop a system one iteration apart near the
        # threshold, so hold each to the tolerance itself: the true
        # residual within 2 tol ||b|| (the recurrence's within tol)
        x = fixed.numpy().astype(np.float64)
        res = (np.einsum("nde,ne->nd", a, x) + rg[:, None] * x - b)
        bn = np.linalg.norm(b, axis=1)
        assert (np.linalg.norm(res, axis=1) <= 2 * tol * bn).all()


def test_one_iteration_matches_jax():
    # max_iters=1: x = (r.r / p.Ap) b, the first step alone
    rng = np.random.default_rng(2)
    a = _random_spd(rng, 12, 8)
    b = rng.normal(size=(12, 8)).astype(np.float32)
    rg = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    got = solve.cg_solve(_t(a), _t(b), max_iters=1, ridge=_t(rg)).numpy()
    want = np.asarray(jsolve.cg_solve(a, b, max_iters=1, ridge=rg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ab = np.einsum("nde,ne->nd", a, b) + rg[:, None] * b
    step = (b * b).sum(1) / (b * ab).sum(1)
    np.testing.assert_allclose(got, step[:, None] * b, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small():
    # tests/test_models_ml1m.py::test_use_cg_epoch_matches_exact's data
    rng = np.random.default_rng(7)
    pairs = np.unique(np.stack([rng.integers(0, 150, 4000),
                                rng.integers(0, 70, 4000)], 1),
                      axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"))


@pytest.mark.parametrize("name", EXACT)
def test_use_cg_epoch_matches_the_exact_epoch(small, name, monkeypatch):
    # tests/test_models_ml1m.py::test_use_cg_epoch_matches_exact on the
    # port for each exact model: CG to 1e-10 (100 iterations) lands on
    # the direct solve within its bound, rtol 1e-3, atol 1e-4; the CG
    # epoch never reaches the inverse-Cholesky kernel's wrapper
    _, _, ds, dd = small
    calls = []
    wrapper = block_chol.chol_inverse_small
    monkeypatch.setattr(block_chol, "chol_inverse_small",
                        lambda a, r: calls.append(1) or wrapper(a, r))
    embs, n_calls = [], []
    for use_cg in (False, True):
        m = get_model(name, Config(dim=16, use_cg=use_cg, seed=13,
                                   **MODEL_CFG[name]),
                      ds.num_users, ds.num_items, device="cpu")
        m.initialize(dd)
        calls.clear()
        m.train_epoch(dd)
        n_calls.append(len(calls))
        embs.append((m.state.user_emb.numpy(), m.state.item_emb.numpy()))
    assert n_calls[0] > 0 and n_calls[1] == 0
    np.testing.assert_allclose(embs[1][0], embs[0][0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(embs[1][1], embs[0][1], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", EXACT)
def test_use_cg_epoch_from_jax_tables_matches_jax(small, name):
    # one CG epoch from the JAX package's tables against its CG epoch:
    # the bound of the direct epochs, rtol 2e-4, atol 2e-5 * dim / 8
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG[name], dim=16, use_cg=True, compute_dtype="f32",
               seed=5)
    jm = jx.get_model(name, jx.Config(**cfg), jds.num_users, jds.num_items)
    jm.initialize(jdd)
    tm = get_model(name, Config(**cfg), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd)
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    got, want = tm.export_state(dd), jm.export_state(jdd)
    for key in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                   atol=4e-5, err_msg=key)
    # the xi bound of tests/test_torch_ops.py::test_compute_xi_matches_jax
    assert got["xi"] == pytest.approx(want["xi"], abs=4e-5)


def test_cg_max_iterations_and_tolerance_reach_the_solver(monkeypatch):
    # --cg_max_iterations / --cg_error_tolerance are parsed and passed to
    # every CG solve of training and evaluation
    from safer2_recommender_tpu_torch import cli

    seen = []
    real = solve.cg_solve

    def spy(a, b, **kw):
        seen.append((kw["max_iters"], kw["tol"]))
        return real(a, b, **kw)

    monkeypatch.setattr(solve, "cg_solve", spy)
    res = cli.run(["--model_name", "safer2", "--device", "cpu", "--dim", "8",
                   "--uobs_weight", "0.004", "--l2_reg", "0.004",
                   "--alpha", "0.3", "--bandwidth", "0.15", "--epoch", "1",
                   "--print_train_stats", "0", "--use_cg", "1",
                   "--cg_max_iterations", "3", "--cg_error_tolerance", "1e-4",
                   "--train_data", os.path.join(ML1M_DIR, "train.csv"),
                   "--test_train_data",
                   os.path.join(ML1M_DIR, "validation_tr.csv"),
                   "--test_test_data",
                   os.path.join(ML1M_DIR, "validation_te.csv")])
    assert res.model.cfg.use_cg and res.model.cfg.cg_max_iterations == 3
    assert seen and set(seen) == {(3, 1e-4)}
    assert np.isfinite(res.metrics.mean_ndcg()).all()


def test_cg_model_serves_and_folds_in_like_jax(small):
    # the CG fold-in (an exact model's one re-projection) against the JAX
    # package's, and a Server over the CG model against recommend()
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG["safer2"], dim=16, use_cg=True, compute_dtype="f32",
               seed=5)
    jm = jx.get_model("safer2", jx.Config(**cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    tm = get_model("safer2", Config(**cfg), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=1)
    held = ds.user_ids < 40
    fold = FoldInData.build(Dataset(ds.user_ids[held], ds.item_ids[held]),
                            Dataset(ds.user_ids[held], ds.item_ids[held]),
                            num_items=ds.num_items, device="cpu")
    jfold = jx.FoldInData.build(
        jx.Dataset(ds.user_ids[held], ds.item_ids[held]),
        jx.Dataset(ds.user_ids[held], ds.item_ids[held]),
        num_items=ds.num_items)
    got = tm._fold_in(tm.state, tm._permute_fold(fold)).numpy()
    want = np.asarray(jm._fold_in_jit(jm.state, jm._permute_fold(jfold)))
    n = fold.n_eval
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-4, atol=4e-5)
    assert tm._fold_in_split() is None
    # CVaR-MF's fold-in solves directly whatever use_cg says, so at dim
    # 128 the Server still splits off the Woodbury rows
    cvar = get_model("cvar_mf", Config(dim=128, use_cg=True), ds.num_users,
                     ds.num_items, device="cpu")
    assert cvar._fold_in_split() == 64
    hist = Dataset(ds.user_ids[held], ds.item_ids[held])
    su, sids = Server(tm, k=10).recommend(hist)
    du, dids = tm.recommend(hist, k=10)
    np.testing.assert_array_equal(su, du)
    np.testing.assert_array_equal(sids, dids)
