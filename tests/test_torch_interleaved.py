"""The reference-order blockwise sweep of the ++ models
(``Config.block_interleaved``, ``common.block_sweep_interleaved``) in the
port against the JAX package, float64 numpy oracles and its own
identities, on the CPU: epochs from carried JAX tables, the oracles of
tests/test_numpy_oracle.py, block_size == dim against iALS, the carried
loss against a fresh one, the wide (column-chunked) route against the
narrow one, the fold-in, serving, checkpoints and the solve count.

The bound everywhere, unless stated: rtol 2e-4, atol 2e-5 * max(1,
dim / 8), the float64 oracles' own (tests/test_numpy_oracle.py)."""

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.ops import quantile as jquantile
from safer2_recommender_tpu_torch import (CheckpointManager, Config, Dataset,
                                          DeviceData, FoldInData, Server,
                                          get_model, interop)
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import block_chol, quantile, smoothing
from safer2_recommender_tpu_torch.probes import oracle

# reference *_test.cc fixtures (tests/test_models_ml1m.py:34-123)
SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)
IALS_CFG = dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0, stdev=0.1)
MODEL_CFG = {"ialspp": IALS_CFG, "safer2pp": SAFER_CFG}


def _atol(dim):
    return 2e-5 * max(1, dim / 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(pairs):
    pairs = np.unique(pairs, axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"))


@pytest.fixture(scope="module")
def small():
    """The oracle's dataset (tests/test_numpy_oracle.py::small), built by
    both packages."""
    rng = np.random.default_rng(42)
    return _both(np.stack([rng.integers(0, 90, 2500),
                           rng.integers(0, 40, 2500)], 1))


def _pair(name, cfg_kw, jds, jdd, ds, dd):
    """(JAX model, port model holding its initialized tables)."""
    jm = jx.get_model(name, jx.Config(**cfg_kw), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    tm = get_model(name, Config(**cfg_kw), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd)
    return jm, tm


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,dim", [("ialspp", 8), ("ialspp", 16),
                                      ("safer2pp", 8), ("safer2pp", 16)])
def test_interleaved_epochs_from_jax_tables_match_jax(small, name, dim):
    # two epochs, so the second reads the first's carried loss (SAFER2++'s
    # xi and z) and the predictions are rebuilt from carried tables;
    # xi within 4e-5 (tests/test_torch_ops.py::test_compute_xi_matches_jax)
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG[name], dim=dim, block_size=4, compute_dtype="f32",
               seed=5, block_interleaved=True)
    jm, tm = _pair(name, cfg, jds, jdd, ds, dd)
    assert not tm._loss_lags_one_epoch
    for epoch in range(2):
        jm.train_epoch(jdd)
        tm.train_epoch(dd)
        got, want = tm.export_state(dd), jm.export_state(jdd)
        for key in ("user_emb", "item_emb", "user_loss", "dual_weight"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                       atol=_atol(dim),
                                       err_msg=f"{key}, epoch {epoch}")
        assert got["xi"] == pytest.approx(want["xi"], abs=4e-5)
    assert tm.state.steps == 2


@pytest.mark.parametrize("name", ["ialspp", "safer2pp"])
def test_interleaved_fold_in_matches_jax(small, name):
    # an interleaved model folds in by blockwise sweeps (no eigenbasis),
    # as the JAX package's does; on its tables after one interleaved epoch
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG[name], dim=16, block_size=4, compute_dtype="f32",
               seed=5, block_interleaved=True)
    jm, tm = _pair(name, cfg, jds, jdd, ds, dd)
    jm.train_epoch(jdd)
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=1)
    held = ds.user_ids < 30
    even = ds.item_ids % 2 == 0
    tr = (ds.user_ids[held & even], ds.item_ids[held & even])
    te = (ds.user_ids[held & ~even], ds.item_ids[held & ~even])
    jfold = jx.FoldInData.build(jx.Dataset(*tr), jx.Dataset(*te),
                                num_items=ds.num_items)
    fold = FoldInData.build(Dataset(*tr), Dataset(*te),
                            num_items=ds.num_items, device="cpu")
    want = np.asarray(jm._fold_in_jit(jm.state, jm._permute_fold(jfold)))
    got = tm._fold_in(tm.state, tm._permute_fold(fold)).numpy()
    n = fold.n_eval
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-4, atol=_atol(16))
    res, jres = tm.evaluate_dataset(fold), jm.evaluate_dataset(jfold)
    np.testing.assert_allclose(res.mean_ndcg(), jres.mean_ndcg(), atol=1e-4)


# --------------------------------------------------------------------------
# float64 oracles (tests/test_numpy_oracle.py:373-411, :444-520)
# --------------------------------------------------------------------------


def _init_tables(model, dd):
    out = model.export_state(dd)
    return (out["user_emb"].astype(np.float64),
            out["item_emb"].astype(np.float64))


def _adjacency(ds):
    return oracle.Adjacency(ds.user_ids, ds.item_ids, ds.num_users,
                            ds.num_items)


def test_ialspp_interleaved_epoch_matches_numpy_oracle(small):
    # per block s, StepU(s) for all users then StepV(s) for all items,
    # the local / local-global Gramians from the LIVE other table
    # (ialspp.h:208-261, :362-365)
    _, _, ds, dd = small
    cfg = Config(dim=8, block_size=4, compute_dtype="f32", seed=5,
                 block_interleaved=True, **IALS_CFG)
    m = get_model("ialspp", cfg, ds.num_users, ds.num_items, device="cpu")
    u1, v1 = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = oracle.ialspp_interleaved(adj, cfg, u1, v1)

    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)
    # the stored loss is the END-of-epoch one, /|H|, no halving
    for u in list(adj.by_u)[:10]:
        assert got["user_loss"][u] == pytest.approx(want["user_loss"][u],
                                                     rel=2e-4, abs=2e-5)


def test_safer2pp_interleaved_epoch_matches_numpy_oracle(small):
    # user blocks (safer2pp.h:97-159) against the live V^T V, item blocks
    # against the live raw-dual-weighted U^T diag(z) U with z/|H_u| slot
    # weights (safer2pp.h:161-216, :532-544), per block in turn
    # (safer2pp.h:303-319); xi_iterations=0 keeps xi at its epoch-0 warm
    # start (the mean loss)
    _, _, ds, dd = small
    cfg = Config(dim=8, block_size=4, uobs_weight=0.004, l2_reg=0.004,
                 alpha=0.3, bandwidth=0.15, xi_iterations=0,
                 pd_iterations=1, compute_dtype="f32", seed=5,
                 block_interleaved=True)
    m = get_model("safer2pp", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    u1, v1 = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = oracle.safer2pp_interleaved(adj, cfg, u1, v1)

    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["dual_weight"], want["dual_weight"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["xi"], want["xi"], rtol=1e-4, atol=1e-6)
    # the END-of-epoch loss, from the carried predictions
    present = adj.present
    np.testing.assert_allclose(got["user_loss"][present],
                               want["user_loss"][present], rtol=2e-4,
                               atol=2e-5)


# --------------------------------------------------------------------------
# identities (tests/test_models_ml1m.py:179-238, :414-451)
# --------------------------------------------------------------------------


def _data(seed, n_users, n_items, n):
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n_users, n),
                                rng.integers(0, n_items, n)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds, device="cpu")


def test_interleaved_full_block_equals_ials():
    # block_size == dim: the delta solve collapses to the exact solve
    # (rhs = A x - b), so one interleaved iALS++ epoch is one iALS epoch;
    # the bound of the JAX package's test, rtol 5e-4, atol 5e-5
    ds, dd = _data(11, 200, 90, 5000)
    embs = []
    for name, inter in (("ials", False), ("ialspp", True)):
        m = get_model(name, Config(dim=16, block_size=16, seed=9,
                                   block_interleaved=inter),
                      ds.num_users, ds.num_items, device="cpu")
        m.train_epoch(dd)
        embs.append((m.state.user_emb.numpy(), m.state.item_emb.numpy()))
    np.testing.assert_allclose(embs[0][0], embs[1][0], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(embs[0][1], embs[1][1], rtol=5e-4, atol=5e-5)


def test_interleaved_carried_loss_matches_fresh():
    # the predictions carried over 2 x dim / bs block steps in both views
    # equal a fresh recomputation from the live tables after 2 epochs
    ds, dd = _data(5, 180, 80, 6000)
    cfg = Config(dim=16, block_size=4, block_interleaved=True, seed=3,
                 compute_dtype="f32", uobs_weight=0.02, l2_reg=0.004,
                 alpha=0.3, bandwidth=0.15, xi_iterations=2)
    m = get_model("safer2pp", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epochs(dd, 2)
    fresh = common.user_losses(m.state.user_emb, m.state.item_emb,
                               m.state.item_gramian, dd.by_user,
                               ds.num_users, cfg.uobs_weight, halve=True)
    np.testing.assert_allclose(m.state.user_loss.numpy(), fresh.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_interleaved_wide_path_matches_narrow(monkeypatch):
    # every bucket wider than dim forced through the column-chunked
    # route (chunks of 12, the last narrower) reproduces the narrow
    # epoch: tables and the carried-prediction loss
    ds, dd = _data(8, 100, 50, 4000)
    cfg = Config(dim=16, block_size=4, block_interleaved=True, seed=2,
                 compute_dtype="f32", alpha=0.3, bandwidth=0.15)

    def run():
        m = get_model("safer2pp", cfg, ds.num_users, ds.num_items,
                      device="cpu")
        m.initialize(dd)
        m.train_epoch(dd)
        return (m.state.user_emb.numpy(), m.state.item_emb.numpy(),
                m.state.user_loss.numpy())

    narrow = run()
    monkeypatch.setattr(tasm, "WIDE_SLAB_BYTES", 1)
    monkeypatch.setattr(tasm, "WIDE_CHUNK", 12)
    for side in (dd.by_user, dd.by_item):
        assert any(tasm.is_wide(b, 16) and b.width % 12 for b in side)
    wide = run()
    for got, want in zip(wide, narrow):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["ialspp", "safer2pp"])
def test_interleaved_solves_once_per_bucket_per_block_per_side(small, name,
                                                               monkeypatch):
    # the launch count the card is held to: every block solve of every
    # bucket on each side reaches the kernel's wrapper once, at r = bs
    # (here 8: a 4 x 4 block is padded to the kernel's smallest size)
    _, _, ds, dd = small
    cfg = Config(dim=16, block_size=8, block_interleaved=True, seed=5,
                 **MODEL_CFG[name])
    m = get_model(name, cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    shapes = []
    wrapper = block_chol.chol_inverse_small
    monkeypatch.setattr(block_chol, "chol_inverse_small",
                        lambda a, r: shapes.append(a.shape) or wrapper(a, r))
    m.train_epoch(dd)
    blocks = cfg.dim // cfg.block_size
    assert len(shapes) == blocks * (len(dd.by_user) + len(dd.by_item))
    assert {s[1] for s in shapes} == {8}
    assert sorted(s[0] for s in shapes) == sorted(
        b.n_rows for b in dd.by_user + dd.by_item for _ in range(blocks))


# --------------------------------------------------------------------------
# serving and checkpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,dim,bs,split", [
    ("ialspp", 16, 4, None), ("safer2pp", 16, 4, None),
    ("safer2pp", 32, 16, 8)])
def test_server_equals_recommend_on_an_interleaved_model(small, name, dim,
                                                         bs, split):
    # the Server's program over an interleaved model (blockwise fold-in)
    # returns recommend()'s ids in every row; at block 16 histories of
    # <= 8 items solve each block by the block-level Woodbury, so the
    # Server packs them in a bucket of their own
    _, _, ds, dd = small
    m = get_model(name, Config(dim=dim, block_size=bs,
                               block_interleaved=True, seed=5,
                               **MODEL_CFG[name]),
                  ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epoch(dd)
    assert m._fold_in_split() == split
    # users 0-19 send their first 5 items, users 20-39 all of theirs
    first = np.concatenate(([True], ds.user_ids[1:] != ds.user_ids[:-1]))
    pos = np.arange(ds.nnz) - np.maximum.accumulate(
        np.where(first, np.arange(ds.nnz), 0))
    held = (ds.user_ids < 40) & ((ds.user_ids >= 20) | (pos < 5))
    hist = Dataset(ds.user_ids[held], ds.item_ids[held])
    su, sids = Server(m, k=10).recommend(hist)
    du, dids = m.recommend(hist, k=10)
    np.testing.assert_array_equal(su, du)
    np.testing.assert_array_equal(sids, dids)


def test_interleaved_resume_equals_continued_training(small, tmp_path):
    # save after 1 epoch, continue to 3; a fresh model restored from the
    # checkpoint and trained 2 epochs ends on the same state bit for bit
    # (the interleaved epoch reads only the state: the carried loss
    # drives xi and z)
    _, _, ds, dd = small
    cfg = Config(dim=16, block_size=4, block_interleaved=True, seed=5,
                 **SAFER_CFG)
    m = get_model("safer2pp", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epoch(dd)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(m.state, epoch=1, meta=m.checkpoint_meta(),
             generator=m.generator)
    m.train_epochs(dd, 2)
    resumed = get_model("safer2pp", cfg, ds.num_users, ds.num_items,
                        device="cpu")
    state, epoch, meta = mgr.restore_with_meta(resumed.state,
                                               generator=resumed.generator)
    assert epoch == 1
    resumed.state = state
    resumed.load_checkpoint_meta(meta)
    resumed.train_epochs(dd, 2)
    got, want = resumed.export_state(), m.export_state()
    for key in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["xi"] == want["xi"] and resumed.state.steps == 3


# --------------------------------------------------------------------------
# the MSD config's xi (a finding of the dim-512 runs, pinned)
# --------------------------------------------------------------------------


def test_msd_config_xi_stalls_where_the_jax_package_stalls():
    # At the MSD config (bandwidth 0.1) on losses like ML-1M's after one
    # epoch (0.03-0.33), the smoothed objective's value (safer2.h:652-689)
    # is lowest at a smaller xi than the root of the gradient that drives
    # Newton: Armijo then rejects the steps toward the root, and xi stops
    # where the mean dual weight is ~0.34, not alpha = 0.3. Both packages
    # stop at the same xi (within 4e-5, the bound of
    # tests/test_torch_ops.py::test_compute_xi_matches_jax), so a dual
    # weight off alpha after an epoch of such a run is not the port's.
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    loss = (0.03 + 0.3 * rng.beta(2.0, 5.0, 4000)).astype(np.float32)
    kw = dict(bandwidth=0.1, alpha=0.3, use_epanechnikov=False,
              use_snr=False, sampling_ratio=0.1)
    got = quantile.compute_xi(torch.from_numpy(loss), 0.55, None,
                              nr_iterations=50, **kw)
    want = jquantile.compute_xi(jnp.asarray(loss), jnp.float32(0.55),
                                jax.random.PRNGKey(0), nr_iterations=50,
                                **kw)
    assert float(got) == pytest.approx(float(want), abs=4e-5)
    mean_dual = float(smoothing.dual_weight(torch.from_numpy(loss), got, 0.1,
                                            False).mean())
    assert mean_dual > 0.32
    # the float64 root of the gradient, where the mean dual weight is
    # alpha, has a HIGHER value than the stall point
    x64 = torch.from_numpy(loss.astype(np.float64))
    qkw = dict(bandwidth=0.1, alpha=0.3, use_epanechnikov=False)
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        g = quantile.evaluate_quantile(torch.tensor(mid, dtype=torch.float64),
                                       x64, **qkw)[1]
        lo, hi = (mid, hi) if g < 0 else (lo, mid)
    root = torch.tensor(mid, dtype=torch.float64)
    assert float(smoothing.dual_weight(x64, root, 0.1, False).mean()) == \
        pytest.approx(0.3, abs=1e-6)
    f_stall = quantile.evaluate_quantile(got.double(), x64, **qkw)[0]
    f_root = quantile.evaluate_quantile(root, x64, **qkw)[0]
    assert float(f_stall) < float(f_root)
