"""The five models beside SAFER2 (iALS, ERM-MF, CVaR-MF, iALS++,
SAFER2++) in the port against the JAX package and float64 numpy oracles,
on the CPU: whole epochs, fold-ins, the model surface. Their ops are in
tests/test_torch_block_sweep.py, their ML-1M gates in
tests/test_torch_models_ml1m.py.

The two packages draw their initial tables from different generators,
so the parity tests carry the JAX package's tables across with
``interop.state_from_jax``; only numpy crosses between them. The bound
everywhere, unless stated: rtol 2e-4, atol 2e-5 * max(1, dim / 8), the
float64 oracles' own (tests/test_numpy_oracle.py)."""

import logging

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu_torch import (MODEL_REGISTRY, Config, Dataset,
                                          DeviceData, FoldInData, get_model,
                                          interop)
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import woodbury as twb
from safer2_recommender_tpu_torch.probes import oracle
from safer2_recommender_tpu_torch.utils.device import DeviceUnavailable

NEW_MODELS = ("ials", "erm_mf", "cvar_mf", "ialspp", "safer2pp")

# reference *_test.cc fixtures (tests/test_models_ml1m.py:34-123)
SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)
IALS_CFG = dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0, stdev=0.1)
MODEL_CFG = {
    "ials": IALS_CFG,
    "ialspp": IALS_CFG,
    "erm_mf": dict(uobs_weight=0.004, l2_reg=0.005, stdev=0.1, alpha=0.3),
    "cvar_mf": dict(uobs_weight=0.008, l2_reg=0.002, stdev=0.1, alpha=0.3,
                    stepsize=0.4),
    "safer2pp": SAFER_CFG,
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _atol(dim):
    return 2e-5 * max(1, dim / 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small, and the whole suite runs several
    worker processes side by side: one intra-op thread per process keeps
    them from oversubscribing the cores (the results do not depend on
    the thread count)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(pairs, **kw):
    pairs = np.unique(pairs, axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds, **kw), ds,
            DeviceData.build(ds, device="cpu", **kw))


@pytest.fixture(scope="module")
def small():
    """The oracle's dataset (tests/test_numpy_oracle.py::small), built by
    both packages."""
    rng = np.random.default_rng(42)
    return _both(np.stack([rng.integers(0, 90, 2500),
                           rng.integers(0, 40, 2500)], 1))


@pytest.fixture(scope="module")
def dense():
    """tests/test_torch_safer2.py::dense: users with short histories
    (full-dim Woodbury at dim 128), 30 items with long ones (width 256:
    rotated direct solves, or bs-blocks in the ++ models) and 50 with
    short ones."""
    rng = np.random.default_rng(11)
    return _both(np.concatenate([
        np.stack([rng.integers(0, 300, 9000), rng.integers(0, 30, 9000)], 1),
        np.stack([rng.integers(0, 300, 1500),
                  rng.integers(30, 80, 1500)], 1)]))


@pytest.fixture(scope="module")
def hot():
    """One item with 600 users (a width-1024 bucket) and a tail
    (tests/test_torch_woodbury.py::hot)."""
    rng = np.random.default_rng(2)
    hot_ = np.stack([np.arange(600), np.zeros(600, dtype=np.int64)], 1)
    tail = np.stack([rng.integers(0, 600, 5000),
                     rng.integers(1, 80, 5000)], 1)
    return _both(np.concatenate([hot_, tail]))


def _patch_wide(monkeypatch, chunk=256):
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(mod, "WIDE_CHUNK", chunk)


def _pair(name, cfg_kw, jds, jdd, ds, dd, steps=0):
    """(JAX model, port model holding its current tables)."""
    jm = jx.get_model(name, jx.Config(**cfg_kw), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    tm = get_model(name, Config(**cfg_kw), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=steps)
    return jm, tm


def _assert_states_close(got, want, dim):
    for name in ("user_emb", "item_emb", "dual_weight", "user_loss"):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=_atol(dim), err_msg=name)
    assert got["xi"] == pytest.approx(want["xi"], rel=1e-4, abs=1e-6)


# --------------------------------------------------------------------------
# whole epochs against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,epochs", [
    ("ials", 1), ("erm_mf", 1), ("cvar_mf", 1), ("cvar_mf", 2),
    ("ialspp", 1), ("safer2pp", 1)])
def test_epochs_from_jax_tables_match_jax(small, name, epochs):
    # dim 8, block 4: every solve direct, the ++ models block by block
    cfg = dict(MODEL_CFG[name], dim=8, block_size=4, compute_dtype="f32",
               seed=5)
    jm, tm = _pair(name, cfg, *small)
    jdd, dd = small[1], small[3]
    for _ in range(epochs):
        jm.train_epoch(jdd)
        tm.train_epoch(dd)
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), 8)
    assert tm.state.steps == epochs


@pytest.mark.parametrize("name", ["ials", "cvar_mf", "ialspp", "safer2pp"])
def test_epoch_at_dim_128_matches_jax(dense, name):
    # one case per solver family (erm_mf shares SAFER2's sweeps, held at
    # dim 128 by tests/test_torch_safer2.py): Woodbury + rotated direct
    # solves (ials), matvec gradient steps (cvar_mf), and the ++ sweeps:
    # the users and the short-history items through the full-dim
    # Woodbury, the width-256 items through 4 blocks of 32
    cfg = dict(MODEL_CFG[name], dim=128, block_size=32, compute_dtype="f32",
               seed=5, eig_refresh_tol=0.0)
    jm, tm = _pair(name, cfg, *dense)
    jdd, dd = dense[1], dense[3]
    twb.reset_solve_paths()
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    paths = dict(twb.SOLVE_PATHS)
    twb.reset_solve_paths()
    if name == "ials":
        assert paths["woodbury"] > 0 and paths["rotated"] > 0
    if name in ("ialspp", "safer2pp"):
        assert paths["woodbury"] > 0 and paths["block"] > 0
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), 128)


@pytest.mark.parametrize("name", ["cvar_mf", "ialspp", "safer2pp"])
def test_wide_epoch_matches_jax(hot, monkeypatch, name):
    # the hot item's bucket streams: wide_matvec in the gradient model,
    # wide_gram_resid in the ++ models
    cfg = dict(MODEL_CFG[name], dim=16, block_size=4, compute_dtype="f32",
               seed=5)
    _patch_wide(monkeypatch)
    jm, tm = _pair(name, cfg, *hot)
    jdd, dd = hot[1], hot[3]
    assert any(tasm.is_wide(b, 16) for b in dd.by_item)
    twb.reset_solve_paths()
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    assert twb.SOLVE_PATHS["wide"] > 0
    twb.reset_solve_paths()
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), 16)


@pytest.mark.parametrize("name", NEW_MODELS)
def test_fold_in_matches_jax(small, name):
    # the evaluation fold-in of each model on JAX-trained tables: one
    # exact solve (ials, erm_mf, cvar_mf), 8 blockwise sweeps (the ++
    # models at dim 8, where no eigenbasis exists)
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG[name], dim=8, block_size=4, compute_dtype="f32",
               seed=5)
    jm, tm = _pair(name, cfg, *small)
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
    assert got.shape == want.shape == (fold.n_pad, 8)
    n = fold.n_eval
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-4, atol=2e-5)
    res, jres = tm.evaluate_dataset(fold), jm.evaluate_dataset(jfold)
    np.testing.assert_allclose(res.mean_ndcg(), jres.mean_ndcg(), atol=1e-4)


@pytest.mark.parametrize("name", ["ialspp", "safer2pp"])
def test_fold_in_at_dim_128_collapses_to_one_exact_solve(dense, name):
    # with an eigenbasis (dim >= 128) the default fold-in sends every
    # eligible bucket through ONE full-dim Woodbury solve whatever
    # n_sweeps says; under the interleaved fall-back (dim % bs != 0) it
    # stays blockwise. Both match the JAX package.
    jds, jdd, ds, dd = dense
    held = ds.user_ids < 40
    fold_ds = Dataset(ds.user_ids[held], ds.item_ids[held])
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    jfold = jx.FoldInData.build(
        jx.Dataset(fold_ds.user_ids, fold_ds.item_ids), jx.Dataset(*empty),
        num_items=ds.num_items, dim=128)
    fold = FoldInData.build(fold_ds, Dataset(*empty),
                            num_items=ds.num_items, device="cpu", dim=128)
    for kw, path in ((dict(block_size=32), "woodbury"),
                     (dict(block_size=48, block_interleaved=True), "block")):
        cfg = dict(MODEL_CFG[name], dim=128, compute_dtype="f32", seed=5,
                   eig_refresh_tol=0.0, eval_fold_in_epochs=2, **kw)
        jm, tm = _pair(name, cfg, *dense)
        twb.reset_solve_paths()
        got = tm._fold_in(tm.state, tm._permute_fold(fold)).numpy()
        assert twb.SOLVE_PATHS[path] > 0
        twb.reset_solve_paths()
        want = np.asarray(jm._fold_in_jit(jm.state, jm._permute_fold(jfold)))
        n = fold.n_eval
        np.testing.assert_allclose(got[:n], want[:n], rtol=2e-4,
                                   atol=_atol(128))


# --------------------------------------------------------------------------
# float64 oracles (tests/test_numpy_oracle.py; probes/oracle.py) against
# the port
# --------------------------------------------------------------------------


def _init_tables(model, dd):
    out = model.export_state(dd)
    return (out["user_emb"].astype(np.float64),
            out["item_emb"].astype(np.float64))


def _adjacency(ds):
    return oracle.Adjacency(ds.user_ids, ds.item_ids, ds.num_users,
                            ds.num_items)


@pytest.mark.parametrize("which", ["small-8", "dense-128"])
def test_ials_epoch_matches_numpy_oracle(small, dense, which):
    # dim 8 runs the direct path; dim 128 the Woodbury exact solves and
    # the rotated direct assembly (reference ials.h:317-365)
    _, _, ds, dd = small if which == "small-8" else dense
    dim = int(which.split("-")[1])
    cfg = Config(dim=dim, compute_dtype="f32", seed=5, **IALS_CFG)
    m = get_model("ials", cfg, ds.num_users, ds.num_items, device="cpu")
    u0, v0 = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = oracle.ials(adj, cfg, u0, v0)
    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=_atol(dim))
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=_atol(dim))
    # iALS's stored loss is the PRE-epoch model's, with no /2
    # (ials.h:70-86)
    for u in list(adj.by_u)[:10]:
        assert got["user_loss"][u] == pytest.approx(want["user_loss"][u],
                                                     rel=2e-4, abs=2e-5)


def test_erm_mf_epoch_matches_numpy_oracle(small):
    # constant-alpha dual weighting and the item_reg sum(1/|H_u|) law
    # (reference erm_mf.h:91-210, :384-395, :580-586)
    _, _, ds, dd = small
    cfg = Config(dim=8, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 compute_dtype="f32", seed=5)
    m = get_model("erm_mf", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    u0, v0 = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = oracle.erm_mf(adj, cfg, u0, v0)
    loss0 = want["user_loss"]
    # initialize computes the losses and nothing else
    init = m.export_state(dd)
    np.testing.assert_allclose(init["user_loss"][adj.present],
                               loss0[adj.present], rtol=2e-4, atol=2e-5)
    assert init["xi"] == 0.0 and m.state.steps == 0

    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["dual_weight"], cfg.alpha, atol=1e-7)
    np.testing.assert_allclose(got["user_loss"][adj.present],
                               loss0[adj.present], rtol=2e-4, atol=2e-5)


def test_cvar_mf_epoch_matches_numpy_oracle(small):
    # two epochs: epoch 1 keeps the carried xi == 0 (every present
    # user's indicator is 1); epoch 2 exercises the exact alpha-quantile
    # (cvar_mf.h:582-595), the z indicator, the eta gradient steps
    # (cvar_mf.h:88-134) and the PRE-update-U V-step (cvar_mf.h:282-295)
    _, _, ds, dd = small
    cfg = Config(dim=8, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 stepsize=0.1, compute_dtype="f32", seed=5)
    m = get_model("cvar_mf", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    assert float(m.state.xi) == 0.0 and m.state.steps == 0
    u, v = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = dict(user_emb=u, item_emb=v)
    for epoch in range(2):
        want = oracle.cvar_mf(adj, cfg, want["user_emb"], want["item_emb"],
                              xi=want.get("xi", 0.0),
                              dual=want.get("dual_weight"), steps=epoch)
        m.train_epoch(dd)

    got = m.export_state(dd)
    present, dual = adj.present, want["dual_weight"]
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["xi"], want["xi"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got["dual_weight"][present], dual[present])
    assert 0 < dual[present].sum() < present.sum()
    np.testing.assert_allclose(got["user_loss"][present],
                               want["user_loss"][present], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("bs", [4, 3])
def test_ialspp_frozen_epoch_matches_numpy_oracle(small, bs):
    # all U blocks against frozen V, then all V blocks against the
    # updated frozen U (ialspp.h:85-145); bs 3 leaves a ragged last
    # block of 2, and 4 x 4 and 3 x 3 systems are padded to the
    # kernel's smallest block, 8
    _, _, ds, dd = small
    cfg = Config(dim=8, block_size=bs, compute_dtype="f32", seed=5,
                 **IALS_CFG)
    m = get_model("ialspp", cfg, ds.num_users, ds.num_items, device="cpu")
    u0, v0 = _init_tables(m, dd)
    want = oracle.ialspp(_adjacency(ds), cfg, u0, v0)
    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)


def test_safer2pp_epoch_matches_numpy_oracle(small):
    # blockwise SAFER2, frozen order: user blocks (safer2pp.h:97-159),
    # item blocks against the raw-dual-weighted Gramian with z/|H_u| slot
    # weights (safer2pp.h:161-216, :532-544); xi_iterations=0 keeps xi at
    # its epoch-0 warm start (the mean loss)
    _, _, ds, dd = small
    cfg = Config(dim=8, block_size=4, uobs_weight=0.004, l2_reg=0.004,
                 alpha=0.3, bandwidth=0.15, xi_iterations=0,
                 pd_iterations=1, compute_dtype="f32", seed=5)
    m = get_model("safer2pp", cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    u1, v1 = _init_tables(m, dd)
    adj = _adjacency(ds)
    want = oracle.safer2pp(adj, cfg, u1, v1)

    m.train_epoch(dd)
    got = m.export_state(dd)
    np.testing.assert_allclose(got["user_emb"], want["user_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["item_emb"], want["item_emb"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["dual_weight"], want["dual_weight"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["xi"], want["xi"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["user_loss"][adj.present],
                               want["user_loss"][adj.present], rtol=2e-4,
                               atol=2e-5)


def test_ialspp_full_block_equals_ials():
    # tests/test_models_ml1m.py::test_ialspp_full_block_equals_ials on
    # the port: with block_size == dim the delta solve collapses to the
    # exact solve (rhs = A x - b, so x - A^-1 rhs = A^-1 b), so one
    # iALS++ epoch reproduces one iALS epoch (same seed, same tables)
    rng = np.random.default_rng(11)
    pairs = np.unique(np.stack([rng.integers(0, 200, 5000),
                                rng.integers(0, 90, 5000)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    dd = DeviceData.build(ds, device="cpu")
    embs = []
    for name in ("ials", "ialspp"):
        m = get_model(name, Config(dim=16, block_size=16, seed=9),
                      ds.num_users, ds.num_items, device="cpu")
        m.train_epoch(dd)
        embs.append((m.state.user_emb.numpy(), m.state.item_emb.numpy()))
    np.testing.assert_allclose(embs[0][0], embs[1][0], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(embs[0][1], embs[1][1], rtol=5e-4, atol=5e-5)


# --------------------------------------------------------------------------
# the model surface: registry, refused modes, carried state, log lines
# --------------------------------------------------------------------------


def test_registry_holds_the_six_models_of_the_jax_package():
    assert sorted(MODEL_REGISTRY) == sorted(jx.models.MODEL_REGISTRY)
    for name, cls in MODEL_REGISTRY.items():
        assert cls.name == name
        assert cls.__name__ == jx.models.MODEL_REGISTRY[name].__name__
    with pytest.raises(ValueError, match="unknown model 'nope'"):
        get_model("nope", Config(), 4, 4, device="cpu")


@pytest.mark.parametrize("name", NEW_MODELS)
def test_new_models_default_to_the_card(name):
    if torch.cuda.is_available():
        m = get_model(name, Config(dim=8, block_size=4), 10, 10)
        assert m.state.user_emb.is_cuda
    else:
        with pytest.raises(DeviceUnavailable,
                           match='CUDA is not available.*device="cpu"'):
            get_model(name, Config(dim=8, block_size=4), 10, 10)


@pytest.mark.parametrize("name", ["ialspp", "safer2pp"])
def test_interleaved_raises_or_falls_back_with_a_warning(small, name, caplog):
    # tests/test_models_ml1m.py::test_interleaved_fallback_warns_at_runtime
    # on the port: where the mode cannot engage (dim % block_size != 0)
    # the frozen sweep runs with one warning; where it engages it runs
    # (tests/test_torch_interleaved.py) and nothing is raised
    _, _, ds, dd = small
    engaged = get_model(name, Config(dim=8, block_size=4,
                                     block_interleaved=True),
                        ds.num_users, ds.num_items, device="cpu")
    assert not engaged._loss_lags_one_epoch
    cfg = Config(dim=8, block_size=3, block_interleaved=True, bandwidth=0.3)
    m = get_model(name, cfg, ds.num_users, ds.num_items, device="cpu")
    assert m._loss_lags_one_epoch
    m.initialize(dd)
    logging.getLogger("safer2_recommender_tpu_torch").propagate = True
    with caplog.at_level(logging.WARNING, "safer2_recommender_tpu_torch"):
        m.train_epoch(dd)
        m.train_epoch(dd)
    hits = [r for r in caplog.records
            if "falling back to the frozen" in r.message]
    assert len(hits) == 1      # once, not per epoch
    assert torch.isfinite(m.state.user_emb).all()


@pytest.mark.parametrize("name", ["ials", "ialspp", "erm_mf", "cvar_mf",
                                  "safer2", "safer2pp"])
def test_loss_phase_flags_and_stats_order_match_jax(name):
    cfg = dict(dim=8, block_size=4)
    jm = jx.get_model(name, jx.Config(**cfg), 6, 5)
    tm = get_model(name, Config(**cfg), 6, 5, device="cpu")
    assert tm._loss_lags_one_epoch == jm._loss_lags_one_epoch
    assert tm._stats_order == jm._stats_order


def test_state_from_jax_carries_every_field_the_models_read(small):
    # a TRAINED CVaR-MF state: xi, the 0/1 dual weights, the losses and
    # the step count all cross, and the next epoch (which takes the exact
    # quantile only because steps > 0) matches
    jds, jdd, ds, dd = small
    cfg = dict(MODEL_CFG["cvar_mf"], dim=8, compute_dtype="f32", seed=5)
    jm, tm = _pair("cvar_mf", cfg, *small)
    for _ in range(3):
        jm.train_epoch(jdd)
    want = jm.export_state(jdd)
    assert want["xi"] != 0.0 and set(np.unique(want["dual_weight"])) <= {
        0.0, 1.0, np.float32(cfg["alpha"])}
    interop.state_from_jax(want, tm, dd, steps=3)
    got = tm.export_state(dd)
    for k in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["xi"] == np.float32(want["xi"]) and tm.state.steps == 3
    assert torch.equal(tm.state.eig_qu, torch.eye(8))
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), 8)
    assert tm.state.steps == 4
