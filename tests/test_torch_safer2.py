"""SAFER2 in the port against the JAX package, a float64 numpy oracle and
the reference's ML-1M quality gates.

The two packages draw their initial tables from different generators,
so the parity tests carry the JAX package's initial tables across with
``interop.state_from_jax``; only numpy crosses between them."""

import os
from math import erf, sqrt

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, get_model, interop)
from safer2_recommender_tpu_torch.ops import solve, woodbury

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))

# reference safer2_test.cc:17-27 (tests/test_models_ml1m.py::_SAFER_CFG)
SAFER_CFG = dict(dim=8, uobs_weight=0.004, l2_reg=0.004, stdev=0.1,
                 alpha=0.3, bandwidth=0.15, xi_iterations=5,
                 pd_iterations=1)


@pytest.fixture(scope="module")
def small():
    """The oracle's dataset (tests/test_numpy_oracle.py::small), built by
    both packages."""
    rng = np.random.default_rng(42)
    pairs = np.unique(np.stack([rng.integers(0, 90, 2500),
                                rng.integers(0, 40, 2500)], 1),
                      axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return jds, jx.DeviceData.build(jds), ds, DeviceData.build(ds)


@pytest.fixture(scope="module")
def ml1m_port():
    """(train Dataset, DeviceData, FoldInData) of the port on ML-1M."""
    train = Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    val_tr = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_tr.csv"))
    val_te = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_te.csv"))
    return (train, DeviceData.build(train),
            FoldInData.build(val_tr, val_te, num_items=train.num_items))


def _carry(jm, jdd, ds, dd, cfg_kw, steps=0):
    """A port model holding ``jm``'s current tables."""
    tm = get_model("safer2", Config(**cfg_kw), ds.num_users, ds.num_items)
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=steps)
    return tm


@pytest.mark.parametrize("dim", [8, 32])
def test_one_epoch_from_jax_tables_matches_jax(small, dim):
    jds, jdd, ds, dd = small
    cfg = dict(SAFER_CFG, dim=dim, compute_dtype="f32", seed=5)
    jm = jx.get_model("safer2", jx.Config(**cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    tm = _carry(jm, jdd, ds, dd, cfg)
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    want, got = jm.export_state(jdd), tm.export_state(dd)
    # the oracle's bounds (tests/test_numpy_oracle.py): f32 error grows
    # with the accumulation length
    atol = 2e-5 * max(1, dim / 8)
    for name in ("user_emb", "item_emb", "dual_weight", "user_loss"):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=atol, err_msg=name)
    assert got["xi"] == pytest.approx(want["xi"], rel=1e-4)
    assert tm.state.steps == 1


def test_safer2_epoch_matches_numpy_oracle(small):
    # tests/test_numpy_oracle.py::test_safer2_epoch_matches_numpy_oracle
    # run against the port: xi_iterations=0 keeps xi at its warm start
    # (the mean loss at epoch 0), so the oracle covers z/U/V/Gramian/loss
    _, _, ds, dd = small
    _check_against_oracle(ds, dd, 8)


def test_safer2_epoch_matches_numpy_oracle_dim128(dense):
    # the same oracle at dim 128, where the port solves through the
    # Woodbury path (every user, the short-history items) and the
    # rotated direct path (the long-history items)
    _, _, ds, dd = dense
    woodbury.reset_solve_paths()
    _check_against_oracle(ds, dd, 128)
    assert woodbury.SOLVE_PATHS["woodbury"] > 0
    assert woodbury.SOLVE_PATHS["rotated"] > 0


def _check_against_oracle(ds, dd, dim):
    cfg = Config(dim=dim, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 bandwidth=0.15, xi_iterations=0, pd_iterations=1,
                 compute_dtype="f32", seed=5)
    m = get_model("safer2", cfg, ds.num_users, ds.num_items)
    m.initialize(dd)
    init = m.export_state(dd)
    u0 = init["user_emb"].astype(np.float64)
    v0 = init["item_emb"].astype(np.float64)
    by_u, by_i = {}, {}
    for u, i in zip(ds.user_ids, ds.item_ids):
        by_u.setdefault(int(u), []).append(int(i))
        by_i.setdefault(int(i), []).append(int(u))
    nu, ni = ds.num_users, ds.num_items

    def losses(ue, ve):
        g = ve.T @ ve
        out = np.zeros(nu)
        for u, hist in by_u.items():
            p = ve[hist] @ ue[u]
            out[u] = 0.5 * (np.mean((p - 1.0) ** 2)
                            + cfg.uobs_weight * ue[u] @ g @ ue[u])
        return out

    loss0 = losses(u0, v0)
    xi = loss0.mean()
    dual = np.full(nu, cfg.alpha)
    for u in by_u:
        r = -(loss0[u] - xi) / cfg.bandwidth
        dual[u] = 1.0 - 0.5 * (1.0 + erf(r / sqrt(2.0)))

    g = v0.T @ v0
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * ni)
    u1 = u0.copy()
    for u, hist in by_u.items():
        vh = v0[hist]
        w = dual[u]
        a = (w * (vh.T @ vh / len(hist) + cfg.uobs_weight * g)
             + u_reg * np.eye(cfg.dim))
        u1[u] = np.linalg.solve(a, (w / len(hist)) * vh.sum(0))

    gw = u1.T @ (u1 * dual[:, None])
    hist_size = np.zeros(nu)
    for u, hist in by_u.items():
        hist_size[u] = len(hist)
    v1 = v0.copy()
    for i, users in by_i.items():
        uh = u1[users]
        wt = np.array([dual[u] / hist_size[u] for u in users])
        stat = sum(1.0 / hist_size[u] for u in users)
        a = (cfg.uobs_weight * gw + (uh * wt[:, None]).T @ uh
             + cfg.l2_reg * (stat + cfg.alpha * cfg.uobs_weight * nu)
             * np.eye(cfg.dim))
        v1[i] = np.linalg.solve(a, (uh * wt[:, None]).sum(0))

    m.train_epoch(dd)
    got = m.export_state(dd)
    present = hist_size > 0
    # the oracle's bounds (tests/test_numpy_oracle.py): f32 error grows
    # with the accumulation length
    atol = 2e-5 * max(1, dim / 8)
    np.testing.assert_allclose(got["user_emb"], u1, rtol=2e-4, atol=atol)
    np.testing.assert_allclose(got["item_emb"], v1, rtol=2e-4, atol=atol)
    np.testing.assert_allclose(got["dual_weight"][present], dual[present],
                               rtol=1e-4, atol=1e-5)
    # the stored loss is phase-shifted: it describes the PRE-epoch model
    np.testing.assert_allclose(got["user_loss"][present], loss0[present],
                               rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def dense():
    """Users with short histories (Woodbury at dim >= 128), 30 items
    with long ones (width 256: the rotated direct path at dim 128 and
    256) and 50 with short ones, built by both packages."""
    rng = np.random.default_rng(11)
    pairs = np.unique(np.concatenate([
        np.stack([rng.integers(0, 300, 9000),
                  rng.integers(0, 30, 9000)], 1),
        np.stack([rng.integers(0, 300, 1500),
                  rng.integers(30, 80, 1500)], 1)]),
        axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return jds, jx.DeviceData.build(jds), ds, DeviceData.build(ds)


def _assert_states_close(got, want, dim):
    # the oracle's bounds (tests/test_numpy_oracle.py)
    atol = 2e-5 * max(1, dim / 8)
    for name in ("user_emb", "item_emb", "dual_weight", "user_loss"):
        np.testing.assert_allclose(got[name], want[name], rtol=2e-4,
                                   atol=atol, err_msg=name)
    assert got["xi"] == pytest.approx(want["xi"], rel=1e-4)


@pytest.mark.parametrize("dim,tol,epochs", [(128, 8e-2, 1), (256, 0.0, 2),
                                            (256, 8e-2, 2)])
def test_epochs_from_jax_tables_match_jax_woodbury_path(dense, dim, tol,
                                                         epochs):
    # dim >= 128: Woodbury and rotated direct solves; at dim 256 with a
    # nonzero tol the bases refresh warm from the previous sweep's.
    # tol 0 takes a full eigh every sweep. tol 8e-2 lets each package
    # drop up to 8% of the rotated Gramian's norm as off-block coupling;
    # from the same bases (up to signs) both drop the same blocks, and
    # two epochs stay well inside the oracle's bounds. Over more epochs
    # a refresh near its threshold can go warm in one package and cold
    # in the other, after which the tables part by far more than f32
    # noise, so the run stops at two epochs.
    jds, jdd, ds, dd = dense
    cfg = dict(SAFER_CFG, dim=dim, compute_dtype="f32", seed=5,
               eig_refresh_tol=tol)
    jm = jx.get_model("safer2", jx.Config(**cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    tm = _carry(jm, jdd, ds, dd, cfg)
    woodbury.reset_solve_paths()
    for _ in range(epochs):
        jm.train_epoch(jdd)
        tm.train_epoch(dd)
    assert woodbury.SOLVE_PATHS["woodbury"] > 0
    assert woodbury.SOLVE_PATHS["rotated"] > 0
    if dim == 256 and tol > 0:
        assert woodbury.SOLVE_PATHS["refresh_warm"] \
            + woodbury.SOLVE_PATHS["refresh_cold"] == 2 * epochs
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), dim)
    q = tm.state.eig_qu.numpy()
    assert np.linalg.norm(q.T @ q - np.eye(dim)) < 1e-3


def test_trained_jax_state_with_bases_matches_next_epoch(dense):
    # a TRAINED JAX state carried across with its warm bases (eig=):
    # the next epoch refreshes from the same bases in both packages
    jds, jdd, ds, dd = dense
    dim = 256
    cfg = dict(SAFER_CFG, dim=dim, compute_dtype="f32", seed=7,
               eig_refresh_tol=8e-2)
    jm = jx.get_model("safer2", jx.Config(**cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    for _ in range(2):
        jm.train_epoch(jdd)
    tm = get_model("safer2", Config(**cfg), ds.num_users, ds.num_items)
    eig = (np.asarray(jm.state.eig_qu), np.asarray(jm.state.eig_qv))
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=2, eig=eig)
    np.testing.assert_array_equal(tm.state.eig_qv.numpy(), eig[1])
    woodbury.reset_solve_paths()
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    # both refreshes go warm from the carried bases (from the identity
    # bases of a fresh state they would go cold)
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 2
    _assert_states_close(tm.export_state(dd), jm.export_state(jdd), dim)
    with pytest.raises(ValueError, match="eig bases"):
        interop.state_from_jax(jm.export_state(jdd), tm, dd,
                               eig=(eig[0][:8, :8], eig[1]))


def test_safer2_ml1m_quality_gates(ml1m_port):
    # tests/test_models_ml1m.py::test_safer2_ml1m on the port
    train, dd, fold = ml1m_port
    m = get_model("safer2", Config(**SAFER_CFG), train.num_users,
                  train.num_items)
    m.initialize(dd)
    for _ in range(10):
        m.train_epoch(dd)
        assert m.get_mean_weight() == pytest.approx(0.3, abs=0.02)
    res = m.evaluate_dataset(fold, k_list=(5, 10, 20, 50, 100))
    assert res.mean_ndcg()[2] >= 0.2


def test_evaluate_and_recommend_on_jax_tables_match_jax(ml1m, ml1m_port):
    jtrain, jdd, jfold = ml1m
    train, dd, fold = ml1m_port
    cfg = dict(SAFER_CFG, compute_dtype="f32")
    jm = jx.get_model("safer2", jx.Config(**cfg), jtrain.num_users,
                      jtrain.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    tm = _carry(jm, jdd, train, dd, cfg, steps=1)
    want = jm.evaluate_dataset(jfold)
    got = tm.evaluate_dataset(fold)
    np.testing.assert_allclose(got.mean_recall(), want.mean_recall(),
                               atol=1e-4)
    np.testing.assert_allclose(got.mean_ndcg(), want.mean_ndcg(), atol=1e-4)

    # serving: catalog ids, outside each user's history, and (near-ties
    # aside) the JAX package's ranking
    val_tr = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_tr.csv"))
    sel = np.isin(val_tr.user_ids, np.unique(val_tr.user_ids)[:64])
    hist = Dataset(val_tr.user_ids[sel], val_tr.item_ids[sel])
    users, ids = tm.recommend(hist, k=10)
    jusers, jids = jm.recommend(jx.Dataset(hist.user_ids, hist.item_ids),
                                k=10)
    np.testing.assert_array_equal(users, jusers)
    seen = set(zip(hist.user_ids.tolist(), hist.item_ids.tolist()))
    assert not any((u, i) in seen for u, row in zip(users, ids) for i in row)
    assert ((ids >= 0) & (ids < train.num_items)).all()
    assert (ids == np.asarray(jids)).mean() >= 0.99


def test_unported_paths_raise(small):
    _, _, ds, _ = small
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        get_model("safer2", Config(compute_dtype="bf16"), ds.num_users,
                  ds.num_items)
    with pytest.raises(ValueError, match="ported: \\['safer2'\\]"):
        get_model("ials", Config(), ds.num_users, ds.num_items)
    m = get_model("safer2", Config(), ds.num_users, ds.num_items)
    with pytest.raises(NotImplementedError, match="item 15"):
        m.recommend(ds, approx=True)
    with pytest.raises(NotImplementedError, match="item 14"):
        solve.solve(torch.eye(8)[None], torch.ones(1, 8), use_cg=True)


def test_rebucketed_data_remaps_trained_tables(small):
    # a trained state fed the same data bucketed differently (another
    # solver order) is remapped, not silently misaligned
    _, _, ds, dd = small
    m = get_model("safer2", Config(**SAFER_CFG), ds.num_users, ds.num_items)
    m.initialize(dd)
    m.train_epoch(dd)
    before = m.export_state(dd)
    dd4 = DeviceData.build(ds, growth=4)
    assert not torch.equal(dd4.user_order, dd.user_order)
    m._note_perms(dd4)
    after = m.export_state(dd4)
    for name in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(after[name], before[name])
    with pytest.raises(ValueError, match="id universe"):
        m._note_perms(DeviceData.build(Dataset(ds.user_ids[:-1],
                                               ds.item_ids[:-1])))
