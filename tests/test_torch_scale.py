"""The port's scale probes (``probes/scale.py``, ``probes/eval_scale.py``,
``probes/serving_scale.py``) on the CPU at small sizes, against the JAX
package: the MSD held-out fold builder against the recipe of
``scripts/bench_eval_50k.py``, ``evaluate_dataset`` on a power-law fold
of the MSD shape for all six models (narrow, and with every bucket
wider than dim on the column-chunked route the zipf head takes at
scale), ``recommend(k=100)`` on ``scripts/bench_serving.py``'s batch
recipe, the near-tie rule, and each probe's ``main`` end to end.

The two packages draw their initial tables from different generators,
so the parity tests carry the JAX package's tables across with
``interop.state_from_jax``; only numpy crosses between them. Bounds:
those of tests/test_torch_models.py (fold-in embeddings rtol 2e-4, atol
2e-5; mean Recall / NDCG within 1e-4), with per-user metrics compared
under the near-tie rule of ``_assert_eval_matches``."""

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.data.synth import powerlaw_dataset as jx_powerlaw
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          get_model, interop)
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.evaluation.metrics import (_mask_history,
                                                             _ranked_ids)
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import woodbury as twb
from safer2_recommender_tpu_torch.probes import (eval_scale, scale,
                                                 serving_scale)

DIM, BLOCK, EVAL_CHUNK = 16, 8, 512
TRAIN_USERS, TRAIN_ITEMS, FOLD_USERS = 1500, 600, 3000
SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)
IALS_CFG = dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0, stdev=0.1)
MODEL_CFG = {
    "ials": IALS_CFG,
    "ialspp": IALS_CFG,
    "erm_mf": dict(uobs_weight=0.004, l2_reg=0.005, stdev=0.1, alpha=0.3),
    "cvar_mf": dict(uobs_weight=0.008, l2_reg=0.002, stdev=0.1, alpha=0.3,
                    stepsize=0.4),
    "safer2": SAFER_CFG,
    "safer2pp": SAFER_CFG,
}
MODELS = tuple(MODEL_CFG)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def train_set():
    """A power-law training set (scale.py's draw at a small size), built
    by both packages."""
    users, items = powerlaw_dataset(TRAIN_USERS, TRAIN_ITEMS, seed=0)
    jds, ds = jx.Dataset(users, items), Dataset(users, items)
    return (jds, jx.DeviceData.build(jds, dim=DIM), ds,
            DeviceData.build(ds, device="cpu", dim=DIM))


@pytest.fixture(scope="module")
def msd_fold(train_set):
    """The held-out fold of eval_scale.heldout_fold at FOLD_USERS users
    against the training catalog, built by both packages."""
    num_items = train_set[2].num_items
    fold, tr, te = eval_scale.heldout_fold(FOLD_USERS, num_items, DIM,
                                           device="cpu")
    jfold = jx.FoldInData.build(jx.Dataset(tr.user_ids, tr.item_ids),
                                jx.Dataset(te.user_ids, te.item_ids),
                                num_items=num_items, dim=DIM)
    return fold, jfold, tr, te


def _cfg(name, **kw):
    return dict(MODEL_CFG[name], dim=DIM, block_size=BLOCK,
                compute_dtype="f32", seed=5, eval_chunk=EVAL_CHUNK, **kw)


def _pair(name, jds, jdd, ds, dd):
    """(JAX model, port model holding its initial tables)."""
    cfg = _cfg(name)
    jm = jx.get_model(name, jx.Config(**cfg), jds.num_users, jds.num_items)
    jm.initialize(jdd)
    tm = get_model(name, Config(**cfg), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd)
    return jm, tm


def _top100(tm, ue, excl):
    scores = torch.from_numpy(ue) @ tm.state.item_emb.T
    return _ranked_ids(_mask_history(scores, excl), 100).numpy()


def _assert_eval_matches(jm, tm, fold, jfold):
    """Fold-in embeddings within rtol 2e-4 / atol 2e-5; per-user Recall
    and NDCG at every k within 1e-6 (the packages sum in another order)
    but on rows whose top 100 differ by near-tie swaps
    (``serving_scale.swaps_are_ties`` under the port's scores: at this
    fold's size one such swap, 1.3e-7 of the top score apart, moves a
    mean by 1.2e-4), at most 1% of the rows; the means of the other rows
    within 1e-4."""
    pf = tm._permute_fold(fold)
    want = np.asarray(jm._fold_in_jit(jm.state, jm._permute_fold(jfold)))
    got = tm._fold_in(tm.state, pf).numpy()
    n = fold.n_eval
    np.testing.assert_allclose(got[:n], want[:n], rtol=2e-4, atol=2e-5)
    res, jres = tm.evaluate_dataset(fold), jm.evaluate_dataset(jfold)
    assert res.recall.shape == jres.recall.shape
    differ = np.flatnonzero(
        (np.abs(res.recall - jres.recall) > 1e-6).any(axis=1)
        | (np.abs(res.ndcg - jres.ndcg) > 1e-6).any(axis=1))
    assert differ.size <= 0.01 * res.recall.shape[0]
    rows = np.flatnonzero(pf.gt_len.numpy() > 0)[differ]
    a = _top100(tm, got[rows], pf.excl[rows])
    b = _top100(tm, want[rows], pf.excl[rows])
    scores = (torch.from_numpy(got[rows]) @ tm.state.item_emb.T).numpy()
    for x, y, s in zip(a, b, scores):
        assert not np.array_equal(x, y) and serving_scale.swaps_are_ties(
            s, x, y)
    same = np.setdiff1d(np.arange(res.recall.shape[0]), differ)
    np.testing.assert_allclose(res.recall[same].mean(0),
                               jres.recall[same].mean(0), atol=1e-4)
    np.testing.assert_allclose(res.ndcg[same].mean(0),
                               jres.ndcg[same].mean(0), atol=1e-4)
    return res


def test_heldout_fold_matches_the_jax_recipe():
    # scripts/bench_eval_50k.py::heldout_fold at 2,000 users x 3,000
    # items, rebuilt with the JAX package's Dataset and FoldInData
    n, num_items, dim = 2000, 3000, 512
    users, items = jx_powerlaw(n, num_items, seed=123)
    te_mask = np.random.default_rng(5).random(users.size) < 0.2
    jfold = jx.FoldInData.build(
        jx.Dataset(users[~te_mask], items[~te_mask]),
        jx.Dataset(users[te_mask], items[te_mask]),
        num_items=num_items, dim=dim)
    fold, tr, te = eval_scale.heldout_fold(n, num_items, dim, device="cpu")
    assert (tr.nnz, te.nnz) == (int((~te_mask).sum()), int(te_mask.sum()))
    assert (fold.n_eval, fold.n_pad, fold.nnz) == (
        jfold.n_eval, jfold.n_pad, jfold.nnz)
    for name in ("excl", "gt", "gt_len"):
        np.testing.assert_array_equal(getattr(fold, name).numpy(),
                                      np.asarray(getattr(jfold, name)))
    np.testing.assert_array_equal(fold.hist_size.numpy(),
                                  np.asarray(jfold.hist_size))
    assert len(fold.by_user) == len(jfold.by_user)
    for b, jb in zip(fold.by_user, jfold.by_user):
        for name in ("row_ids", "col_ids", "length"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(jb, name)))


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_msd_shape_matches_jax(train_set, msd_fold, name):
    # multi-hundred-item fold-in rows, several 512-row scoring chunks;
    # the JAX package's initial tables, carried across (the wide case
    # below starts from a trained epoch)
    fold, jfold, _, _ = msd_fold
    assert max(b.width for b in fold.by_user) >= 256
    assert fold.n_pad // EVAL_CHUNK >= 4
    jm, tm = _pair(name, *train_set)
    res = _assert_eval_matches(jm, tm, fold, jfold)
    assert res.recall.shape[0] > 0.9 * FOLD_USERS


@pytest.mark.parametrize("name", MODELS)
def test_evaluate_msd_shape_on_the_wide_route_matches_jax(
        train_set, msd_fold, monkeypatch, name):
    # every bucket wider than dim streams through column chunks in both
    # packages: the zipf-head item buckets of the training epoch and the
    # long fold-in rows
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(mod, "WIDE_CHUNK", 256)
    fold, jfold, _, _ = msd_fold
    jds, jdd, ds, dd = train_set
    assert any(tasm.is_wide(b, DIM) for b in dd.by_item)
    assert any(tasm.is_wide(b, DIM) for b in fold.by_user)
    jm, tm = _pair(name, *train_set)
    twb.reset_solve_paths()
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    wide_rows = twb.SOLVE_PATHS["wide"]
    got, want = tm.export_state(dd), jm.export_state(jdd)
    for key in ("user_emb", "item_emb"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                   atol=4e-5)
    interop.state_from_jax(want, tm, dd, steps=1)
    twb.reset_solve_paths()
    _assert_eval_matches(jm, tm, fold, jfold)
    if name != "cvar_mf":      # its gradient steps stream, no solve path
        assert wide_rows > 0 and twb.SOLVE_PATHS["wide"] > 0


@pytest.mark.parametrize("name", ["safer2", "ialspp"])
def test_recommend_k100_matches_jax_on_the_serving_recipe(train_set, name):
    ds = train_set[2]
    jm, tm = _pair(name, *train_set)
    batch = serving_scale.new_users(300, ds.num_items)
    assert int(np.bincount(batch.user_ids).max()) > 100
    jusers, jids = jm.recommend(jx.Dataset(batch.user_ids, batch.item_ids),
                                k=100)
    users, ids = tm.recommend(batch, k=100)
    np.testing.assert_array_equal(users, np.asarray(jusers))
    assert ids.shape == (300, 100)
    assert serving_scale.bad_ids(batch, users, ids, ds.num_items) == (0, 0)
    rows, ties = serving_scale.tie_rows(tm, batch, ids, np.asarray(jids))
    assert rows.size <= 3 and ties.size == rows.size


def test_swaps_are_ties():
    score = np.array([1.0, 0.5, 0.5 + 4e-6, 0.2, 0.2 + 1e-3])
    assert serving_scale.swaps_are_ties(score, np.array([0, 1, 2]),
                                        np.array([0, 2, 1]))
    assert not serving_scale.swaps_are_ties(score, np.array([0, 3, 4]),
                                            np.array([0, 4, 3]))
    assert serving_scale.swaps_are_ties(score, np.array([0, 3]),
                                        np.array([0, 3]))


def test_subfold_check_holds_and_catches_a_changed_row(train_set, msd_fold):
    fold, _, tr, te = msd_fold
    ds, dd = train_set[2], train_set[3]
    m = get_model("safer2", Config(**_cfg("safer2")), ds.num_users,
                  ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epochs(dd, 1)
    full = eval_scale.evaluate(m, fold)
    assert full["in_range"] and full["split_equal"]
    assert full["users"] == full["result"].recall.shape[0]
    got = eval_scale.subfold_check(m, tr, te, fold, full, n_sub=700)
    assert got["rows"] > 600 and got["differ"] == got["excused"]
    # a metric that moved with the same top 20 is not excused
    full["result"].ndcg[5, full["result"].k_list.index(20)] += 0.5
    got = eval_scale.subfold_check(m, tr, te, fold, full, n_sub=700)
    assert got["differ"] >= 1 and got["excused"] < got["differ"]


@pytest.mark.parametrize("probe, argv", [
    (scale, ["400", "200", "16", "safer2pp", "--epochs", "1",
             "--device", "cpu"]),
    (scale, ["400", "200", "128", "cvar_mf", "--epochs", "1",
             "--device", "cpu"]),
    (eval_scale, ["--part", "msd", "--num_users", "500", "--num_items",
                  "200", "--heldout", "300", "--dim", "16", "--models",
                  "safer2", "ialspp", "--device", "cpu"]),
    (eval_scale, ["--part", "ml1m", "--dims", "8", "--device", "cpu"]),
    (serving_scale, ["safer2", "128", "60", "--num_users", "500",
                     "--num_items", "200", "--device", "cpu"]),
], ids=["scale", "scale-cvar_mf-dim128", "eval-msd", "eval-ml1m",
        "serving"])
def test_probe_main_runs_on_the_cpu(probe, argv, capsys):
    assert probe.main(argv) == 0
    out = capsys.readouterr().out
    assert "not measured (CPU)" in out or probe is serving_scale \
        or "ml1m" in argv
