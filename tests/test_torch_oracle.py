"""``probes/oracle.py``'s float64 oracles against both packages, on the
CPU: from the same initial tables (the JAX package's, carried into the
port by ``interop.state_from_jax``), the JAX package's epoch and the
port's each match the oracle, for all six models and both ++ orders, at
dims 8, 128 and 256, both packages at the port's default
``eig_refresh_tol`` (0: a full eigh every sweep), and at 256 again at
the JAX package's 0.08, where the epoch's eigenbasis comes through
``woodbury.refresh_eigh`` (its cold branch: the first epoch's carried
basis is the identity). The bound is the oracles' own: rtol 2e-4, atol
2e-5 * max(1, dim / 8) (tests/test_numpy_oracle.py).

At the default the port's second epoch at 256 (SAFER2, iALS, iALS++) is
held to the oracle too. At 0.08 it takes the warm refresh, which drops
up to 8% of the rotated Gramian's norm: iALS's warm epoch lands near
the bound, and iALS++'s errs over ten times as much as its default
epoch (it misses the bound in the JAX package; the port's full-dim
Woodbury sums its rhs from the rotated slab, so its ++ epochs are
several times closer to the oracle). There it is held to the JAX
package's warm epoch from the same carried bases, which it matches
within the oracle's bound, miss for miss. The fold-in's eigenbasis
(``_fold_in_prep``) at the default is an exact eigendecomposition of
the frozen item Gramian, within 1e-6, where the warm one from a stale
carried basis is not. Also the probe's row checks, its refusal of the
CPU and the dim-512 data's routes."""

import dataclasses

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu_torch import (Dataset, DeviceData, FoldInData,
                                          get_model, interop)
from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
from safer2_recommender_tpu_torch.models import ialspp
from safer2_recommender_tpu_torch.ops import woodbury
from safer2_recommender_tpu_torch.probes import eigh, oracle

EIGH_CASES = ("ials", "safer2", "erm_mf", "ialspp", "safer2pp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small():
    """The oracle's dataset, built by both packages, and its
    ``Adjacency``."""
    pairs = oracle.small_pairs()
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"),
            oracle.Adjacency(pairs[:, 0], pairs[:, 1], ds.num_users,
                             ds.num_items))


def _jax_config(cfg):
    names = {f.name for f in dataclasses.fields(jx.Config)}
    return jx.Config(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k in names})


def _f64(exported):
    return {k: (np.asarray(v, dtype=np.float64) if isinstance(v, np.ndarray)
                else v) for k, v in exported.items()}


def _both_packages_match_the_oracle(small, key, dim, tol):
    # both packages' Configs from the same fields, eig_refresh_tol given
    # to both explicitly
    jds, jdd, ds, dd, adj = small
    case = oracle.CASES[key]
    cfg = oracle.config(key, dim, tol)
    jm = jx.get_model(case.model, _jax_config(cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    start = _f64(jm.export_state(jdd))
    tm = get_model(case.model, cfg, ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(start, tm, dd, steps=0)
    exact = (oracle.exact_rows(dd.by_user, dd.user_perm, ds.num_users, dim),
             oracle.exact_rows(dd.by_item, dd.item_perm, ds.num_items, dim))
    want = start
    woodbury.reset_solve_paths()
    for epoch in range(2 if key == "cvar_mf" else 1):
        want = oracle.step_oracle(case, adj, cfg, want, epoch, exact)
        jm.train_epoch(jdd)
        tm.train_epoch(dd)
        for name, got in (("jax", jm.export_state(jdd)),
                          ("port", tm.export_state(dd))):
            err = oracle.errors(got, want, dim)
            assert err["ok"], (name, epoch, err)
    # at 0.08 the first epoch refreshes from the identity basis, cold; at
    # 0 no refresh runs, a full eigh every sweep
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 0
    assert (woodbury.SOLVE_PATHS["refresh_cold"] > 0) == (
        dim == 256 and key in EIGH_CASES and tol > 0)


@pytest.mark.parametrize("dim", [8, 128, 256])
@pytest.mark.parametrize("key", list(oracle.CASES))
def test_both_packages_match_the_oracle(small, key, dim):
    _both_packages_match_the_oracle(small, key, dim, 0.0)


@pytest.mark.parametrize("key", EIGH_CASES)
def test_both_packages_match_the_oracle_at_the_jax_refresh_tol(small, key):
    _both_packages_match_the_oracle(small, key, oracle.WARM_DIM,
                                    JAX_EIG_REFRESH_TOL)


@pytest.mark.parametrize("key", oracle.CARRIED_BASIS)
def test_warm_refresh_epoch_at_256_matches_jax_from_the_same_bases(small,
                                                                   key):
    # one JAX epoch, its tables and eigenbases carried into the port
    # (interop.state_from_jax eig=): the next epoch refreshes warm from
    # the same bases in both packages, and the port's tables are the JAX
    # package's within the oracle's bound; against the oracle both
    # packages pass or both miss
    jds, jdd, ds, dd, adj = small
    dim = oracle.WARM_DIM
    case = oracle.CASES[key]
    cfg = oracle.config(key, dim, JAX_EIG_REFRESH_TOL)
    jm = jx.get_model(case.model, _jax_config(cfg), jds.num_users,
                      jds.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    start = _f64(jm.export_state(jdd))
    tm = get_model(case.model, cfg, ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(start, tm, dd, steps=1, eig=(
        np.asarray(jm.state.eig_qu), np.asarray(jm.state.eig_qv)))
    exact = (oracle.exact_rows(dd.by_user, dd.user_perm, ds.num_users, dim),
             oracle.exact_rows(dd.by_item, dd.item_perm, ds.num_items, dim))
    want = oracle.step_oracle(case, adj, cfg, start, 1, exact)
    woodbury.reset_solve_paths()
    jm.train_epoch(jdd)
    tm.train_epoch(dd)
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 2
    assert woodbury.SOLVE_PATHS["refresh_cold"] == 0
    got_j, got_t = jm.export_state(jdd), tm.export_state(dd)
    err = oracle.errors(got_t, _f64(got_j), dim)
    assert err["ok"], err
    assert (oracle.errors(got_t, want, dim)["ok"]
            == oracle.errors(got_j, want, dim)["ok"])


@pytest.mark.parametrize("key", oracle.CARRIED_BASIS)
def test_default_second_epoch_at_256_is_held_to_the_oracle(small, key):
    # at the default eig_refresh_tol the second epoch's eigenbases are
    # full eighs: held to the oracle's bound, no warm refresh; at the JAX
    # package's 0.08 the same epoch takes the warm refresh, a reading,
    # and iALS++'s errs there over ten times as much as at the default
    # (the oracle can see it)
    _, _, ds, dd, _ = small
    rows = {}
    for tol in (None, JAX_EIG_REFRESH_TOL):
        part = oracle.port_case(key, oracle.WARM_DIM, (ds, dd),
                                torch.device("cpu"), tol)
        rows[tol] = oracle.finish_case(part, *oracle.trajectory(
            key, oracle.WARM_DIM, part["states"][0], part["exact"],
            part["epochs"]))
    row = rows[None]
    assert row["tol"] == 0.0 and row["epochs"] == 2
    assert row["paths"]["refresh_warm"] == 0 and row["paths"]["woodbury"] > 0
    assert not row["reading"] and oracle.row_ok(row), oracle.describe(row)
    assert all(e["ok"] and not e["warm"] for e in row["errors"])
    warm = rows[JAX_EIG_REFRESH_TOL]
    assert warm["reading"] and oracle.row_ok(warm), oracle.describe(warm)
    assert warm["errors"][1]["warm"] and warm["paths"]["refresh_warm"] == 2
    if key == "ialspp":
        assert warm["errors"][1]["abs"] > 10 * row["errors"][1]["abs"]


@pytest.fixture(scope="module")
def stale(small):
    """iALS++ at 256 after one epoch on the small set (default
    tolerance), whose carried user-sweep basis, taken before the item
    sweep, is the stalest the set gives: the state, the Dataset's
    DeviceData and a held-out fold of its users."""
    _, _, ds, dd, _ = small
    m = get_model("ialspp", oracle.config("ialspp", oracle.WARM_DIM),
                  ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epoch(dd)
    pairs = oracle.small_pairs()
    te = np.random.default_rng(3).random(len(pairs)) < 0.2
    fold = FoldInData.build(Dataset(pairs[~te, 0], pairs[~te, 1]),
                            Dataset(pairs[te, 0], pairs[te, 1]),
                            num_items=ds.num_items, device="cpu",
                            dim=oracle.WARM_DIM)
    return m.state, dd, fold


def _fold_in_eig(key, model, state):
    """(Q, lam) of the model's fold-in prep: ``_fold_in_prep``, or
    ``ialspp.fold_in_prep`` for iALS++ (no block eigenbasis beside a
    full-dim one)."""
    if key == "ialspp":
        eig, block_eig, _ = ialspp.fold_in_prep(model, state)
        assert block_eig is None
        return eig
    return model._fold_in_prep(state)[0]


@pytest.mark.parametrize("key", oracle.CARRIED_BASIS)
def test_default_fold_in_prep_is_an_exact_eigh_of_the_frozen_gramian(
        stale, key):
    # the fold-in's eigenbasis of the frozen item Gramian: at the JAX
    # package's 0.08 warm from the stale carried basis, and off the
    # Gramian by more than 1e-6; at the default no refresh, within 1e-6
    # of it and orthogonal within 1e-4; the fold-in equal, bit for bit,
    # to one handed a fresh sym_eigh
    state, dd, fold = stale
    gram = state.item_gramian
    case = oracle.CASES[key]
    models = {}
    for tol in (JAX_EIG_REFRESH_TOL, None):
        cfg = oracle.config(key, oracle.WARM_DIM, tol)
        models[tol] = m = get_model(case.model, cfg, dd.num_users,
                                    dd.num_items, device="cpu")
        m.initialize(dd)
        m.state = state
    woodbury.reset_solve_paths()
    q, lam = _fold_in_eig(key, models[JAX_EIG_REFRESH_TOL], state)
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 1
    assert float(eigh.reconstruction_error(lam, q, gram)) > 1e-6
    woodbury.reset_solve_paths()
    m = models[None]
    q, lam = _fold_in_eig(key, m, state)
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 0
    assert woodbury.SOLVE_PATHS["refresh_cold"] == 0
    assert float(eigh.reconstruction_error(lam, q, gram)) <= 1e-6
    assert eigh.orthogonality(q) <= 1e-4
    lam_f, q_f = woodbury.sym_eigh(gram)
    fresh = (q_f, torch.clamp(lam_f, min=0.0))
    assert torch.equal(q, fresh[0]) and torch.equal(lam, fresh[1])
    pf = m._permute_fold(fold)
    got = m._fold_in(state, pf)
    want = m._fold_in(state, pf, prep=(fresh, None, None)
                      if key == "ialspp" else (fresh, None))
    assert torch.equal(got, want)


def _row(**kw):
    """A row of ``finish_case``'s keys, every check passing."""
    return dict(dict(ok=True, branch_ok=True, sharp_ok=True,
                     control_ok=True, missing=[]), **kw)


def test_row_ok_needs_every_check():
    assert oracle.row_ok(_row())
    for key in ("ok", "branch_ok", "sharp_ok", "control_ok"):
        assert not oracle.row_ok(_row(**{key: False}))
    assert not oracle.row_ok(_row(missing=["wide"]))


def _part(key, dim, states, raw=None, paths=None, tol=0.0):
    return dict(key=key, dim=dim, tol=tol, epochs=len(states) - 1,
                states=states, raw=raw,
                exact=(np.zeros(2, bool), np.zeros(2, bool)),
                paths=dict(dict.fromkeys(woodbury.SOLVE_PATHS, 0),
                           **(paths or {})), missing=[])


def _tables(x):
    return {"user_emb": np.full((2, 2), x), "item_emb": np.zeros((2, 2))}


@pytest.mark.parametrize("dim", [128, oracle.WARM_DIM, 512])
def test_finish_case_holds_every_epoch_but_the_warm_readings(dim):
    # an epoch off the bound fails the row whichever branch it took;
    # only the later epochs of a row at a nonzero eig_refresh_tol (the
    # JAX package's) are readings, and there they must be warm; at the
    # default every epoch is held and none may be warm
    want = [_tables(0.0)] * 3
    far = dict(_tables(1.0), warm=True)
    near = dict(_tables(0.0), warm=False)
    for tol in (0.0, JAX_EIG_REFRESH_TOL):
        row = oracle.finish_case(_part("ials", dim, [near, near, far],
                                       tol=tol), want, 1.0)
        reading = tol > 0
        assert row["reading"] == reading
        assert row["ok"] == reading and row["branch_ok"] == reading
        row = oracle.finish_case(_part("ials", dim, [near, far, near],
                                       tol=tol), want, 1.0)
        assert not row["ok"] and not row["branch_ok"]
        # held at the default: a warm epoch within the bound still fails
        row = oracle.finish_case(_part("ials", dim, [near, near, dict(
            near, warm=True)], tol=tol), want, 1.0)
        assert row["ok"] and row["branch_ok"] == reading
    row = oracle.finish_case(_part("erm_mf", dim, [near, near, far]), want,
                             1.0)
    assert not row["ok"] and not row["reading"]


def test_finish_case_holds_512_to_the_sharp_limit_with_its_control():
    # at 512 the epochs within SHARP_ABS_512, and the raw float32 run of
    # an epoch that decomposes the full-dim Gramian past it
    lim = oracle.SHARP_ABS_512
    want = [_tables(0.0)] * 2
    port = [_tables(0.0), dict(_tables(0.5 * lim), warm=False)]
    raw = [_tables(0.0), _tables(3.0 * lim)]
    eigh_paths = {"woodbury": 10}
    row = oracle.finish_case(_part("erm_mf", 512, port, raw, eigh_paths),
                             want, 1.0)
    assert oracle.row_ok(row) and row["raw"][0]["abs"] == 3.0 * lim
    # the port past the limit (inside the oracle's bound): fails
    row = oracle.finish_case(_part("erm_mf", 512, [port[0], dict(
        _tables(2.0 * lim), warm=False)], raw, eigh_paths), want, 1.0)
    assert row["ok"] and not row["sharp_ok"] and not oracle.row_ok(row)
    # the control within the limit: fails where the eigh is on the path
    row = oracle.finish_case(_part("erm_mf", 512, port, port, eigh_paths),
                             want, 1.0)
    assert not row["control_ok"] and "THE CONTROL PASSED" in \
        oracle.describe(dict(row, block=64, launches=0, carried_orth=None))
    row = oracle.finish_case(_part("cvar_mf", 512, port, port,
                                   {"wide": 2}), want, 1.0)
    assert row["control_ok"] and oracle.row_ok(row)


def test_errors_hold_each_entry_to_the_bound():
    want = {"user_emb": np.array([[1.0, 0.0]]), "item_emb": np.zeros((1, 2))}
    tol = oracle.atol(8) + oracle.RTOL
    got = {"user_emb": want["user_emb"] + [[0.9 * tol, 0.0]],
           "item_emb": want["item_emb"]}
    assert oracle.errors(got, want, 8)["ok"]
    # the second entry's bound is atol alone (its value is 0)
    got["user_emb"] = want["user_emb"] + [[0.0, 1.1 * oracle.atol(8)]]
    err = oracle.errors(got, want, 8)
    assert not err["ok"] and err["abs"] == pytest.approx(1.1 * oracle.atol(8))
    assert not err["warm"]


def test_power_set_reaches_every_route_at_512():
    # the dim-512 data: user histories past 256 but none past 512
    # (rotated, and no wide user bucket), an item past 512 users (a
    # width-1,024 bucket: wide, and direct with the batch it joins), and
    # short ones (Woodbury)
    pairs = oracle.power_pairs()
    users = np.bincount(pairs[:, 0])
    items = np.bincount(pairs[:, 1])
    assert users.size == oracle.POWER_USERS and items.size == oracle.POWER_ITEMS
    assert 256 < users.max() <= 512
    assert items.max() > 512
    assert (users <= 256).sum() > 900 and (items <= 256).sum() > 500


def test_cases_cover_every_model_and_order():
    todo = oracle.cases()
    assert {oracle.CASES[k].model for k, *_ in todo} == {
        "ials", "safer2", "erm_mf", "cvar_mf", "ialspp", "safer2pp"}
    assert {(k, d) for k, d, *_ in todo if d in oracle.DIMS} == {
        (k, d) for k in oracle.CASES for d in oracle.DIMS}
    assert ("ialspp", oracle.BLOCK_WOODBURY_DIM) in todo
    # each at WARM_DIM at the default, then at the JAX package's
    # tolerance beside it
    for k in oracle.CARRIED_BASIS:
        i = todo.index((k, oracle.WARM_DIM))
        assert todo[i + 1] == (k, oracle.WARM_DIM, JAX_EIG_REFRESH_TOL)
    assert all(len(c) == 2 for c in todo if c[1] != oracle.WARM_DIM)


def test_run_cases_on_the_cpu():
    # the probe's own pipeline at dim 8 (run() itself refuses the CPU):
    # the port's epochs here, the oracle's in one spawned process with
    # one BLAS thread, the rows held and described
    rows = oracle.run_cases([("ials", 8), ("cvar_mf", 8)],
                            torch.device("cpu"), workers=1)
    assert [(r["key"], r["dim"], r["epochs"]) for r in rows] == [
        ("ials", 8, 1), ("cvar_mf", 8, 2)]
    for row in rows:
        assert oracle.row_ok(row), oracle.describe(row)
        assert row["oracle_s"] > 0 and "raw" not in row
    assert rows[0]["paths"]["direct"] > 0
    assert "ials dim 8" in oracle.describe(rows[0])


def test_raw_float32_eigh_is_patched_only_inside():
    real = woodbury.sym_eigh
    with oracle.raw_float32_eigh():
        assert woodbury.sym_eigh is torch.linalg.eigh
    assert woodbury.sym_eigh is real
