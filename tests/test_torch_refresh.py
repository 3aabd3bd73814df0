"""The port's default eigenbasis refresh, and ``probes/refresh.py`` on
the CPU.

The port's default ``eig_refresh_tol`` is 0, a full eigh every sweep,
where the JAX package's is 0.08 (its warm refresh): the config, the CLI
and the JAX package's own default. The refresh probe on the oracle's
small set (90 x 40) at dim 256: its coupling share decides the branch as
``refresh_eigh``'s test does; a fork runs the next epoch at both
tolerances from one state without advancing the model, the two equal
bit for bit where no warm refresh ran and apart where one did; the
ML-1M part's runs at both tolerances from the same tables; its
checks."""

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, cli, get_model)
from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
from safer2_recommender_tpu_torch.ops import woodbury
from safer2_recommender_tpu_torch.probes import oracle, refresh

DIM = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def small():
    """The oracle's small set on the CPU and a held-out fold of its
    users."""
    pairs = oracle.small_pairs()
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    te = np.random.default_rng(3).random(len(pairs)) < 0.2
    fold = FoldInData.build(Dataset(pairs[~te, 0], pairs[~te, 1]),
                            Dataset(pairs[te, 0], pairs[te, 1]),
                            num_items=ds.num_items, device="cpu", dim=DIM)
    return ds, DeviceData.build(ds, device="cpu", dim=DIM), fold


def test_default_refresh_tol_is_a_full_eigh_where_the_jax_packages_is_warm():
    assert Config().eig_refresh_tol == 0.0
    assert cli.build_parser().get_default("eig_refresh_tol") == 0.0
    assert jx.Config().eig_refresh_tol == JAX_EIG_REFRESH_TOL == 8e-2


def test_coupling_share_decides_the_refresh_branch():
    # a decaying-spectrum Gramian, drifted, in its old basis: refresh_eigh
    # goes warm just above the probe's share and cold just below it
    rng = np.random.default_rng(4)
    v = rng.normal(size=(2000, DIM)).astype(np.float32) / np.sqrt(DIM)
    v *= (1.0 / np.sqrt(np.arange(1, DIM + 1)))[None, :].astype(np.float32)
    q0 = torch.from_numpy(np.linalg.eigh((v.T @ v).astype(np.float64))[1]
                          .astype(np.float32))
    v = v + 0.05 * rng.normal(size=v.shape).astype(np.float32) * np.abs(v)
    g = torch.from_numpy((v.T @ v).astype(np.float32))
    share = refresh.coupling_share(g, q0)
    assert 1e-3 < share < 0.5
    woodbury.reset_solve_paths()
    woodbury.refresh_eigh(g, q0, share * 1.001)
    assert woodbury.SOLVE_PATHS["refresh_warm"] == 1
    woodbury.refresh_eigh(g, q0, share * 0.999)
    assert woodbury.SOLVE_PATHS["refresh_cold"] == 1


def test_forks_run_the_next_epoch_at_both_tolerances(small):
    ds, dd, _ = small
    cfg = oracle.config("ials", DIM)
    row, = refresh.run_models("small", (ds, dd, cfg), "cpu", ("ials",),
                              (1, 2))
    assert refresh.check(row) == [], refresh.describe(row)
    assert [f["after"] for f in row["forks"]] == [1, 2]
    assert row["warm_by_epoch"] == [0, 0] and len(row["mean_weight"]) == 2
    warm_forks = 0
    for f in row["forks"]:
        jax_run, default = (f["runs"][t] for t in refresh.TOLS)
        assert [c["branch"] for c in default["eighs"]] == ["full", "full"]
        assert all(c["ms"] is None for c in default["eighs"])
        # the first sweep's share is read from the same carried basis
        assert jax_run["eighs"][0]["share"] == default["eighs"][0]["share"]
        warm = any(c["branch"] == "warm" for c in jax_run["eighs"])
        warm_forks += warm
        moved = f["u"]["abs"] + f["v"]["abs"]
        assert (moved > 0) == warm
    # the small set's second and third epochs refresh warm at 0.08
    assert warm_forks == 2
    assert any("not measured (CPU)" in line for line in refresh.describe(row))


def test_clone_starts_from_the_same_state_and_leaves_it(small):
    ds, dd, _ = small
    m = get_model("safer2", oracle.config("safer2", DIM), ds.num_users,
                  ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epoch(dd)
    before = {k: v.clone() for k, v in vars(m.state).items()
              if isinstance(v, torch.Tensor)}
    a, b = (refresh.clone(m, 0.0) for _ in range(2))
    assert a.cfg.eig_refresh_tol == 0.0 and a.state.steps == 1
    for c in (a, b):
        c.train_epochs(dd, 1)
    assert torch.equal(a.state.user_emb, b.state.user_emb)
    assert torch.equal(a.state.item_emb, b.state.item_emb)
    assert m.state.steps == 1
    for k, v in before.items():
        assert torch.equal(getattr(m.state, k), v), k


def test_ml1m_part_runs_both_tolerances_from_the_same_tables(small):
    ds, dd, fold = small
    cfg = oracle.config("safer2", DIM)
    row, = refresh.run_ml1m("cpu", (ds, dd, fold, cfg), after=(1,),
                            epochs=2)
    assert refresh.check(row) == [], refresh.describe(row)
    q = row["quality"]
    assert set(q) == set(refresh.TOLS)
    assert q[0.0]["warm_by_epoch"] == [0, 0] and q[0.0]["fold_in_warm"] == 0
    # the second epoch of the JAX package's run refreshes warm
    assert q[JAX_EIG_REFRESH_TOL]["warm_by_epoch"] == [0, 2]
    # the first epoch is the same full eigh at both tolerances
    assert q[0.0]["mean_weight"][0] == \
        q[JAX_EIG_REFRESH_TOL]["mean_weight"][0]
    for r in q.values():
        assert 0.0 <= r["ndcg20"] <= 1.0 and 0.0 <= r["recall20"] <= 1.0
    assert [f["after"] for f in row["forks"]] == [1]
    assert len(refresh.describe(row)) == 3


def test_check_names_each_fault():
    eigh = dict(branch="full", share=0.5, ms=None)
    run = dict(eighs=[eigh], epoch_ms=1.0, finite=True)
    row = dict(workload="w", model="m", dim=DIM, warm_by_epoch=[0],
               mean_weight=[0.3], forks=[dict(
                   after=1, runs={JAX_EIG_REFRESH_TOL: dict(
                       run, eighs=[dict(eigh, branch="cold")]),
                       0.0: run}, u=dict(abs=0.0, rel=0.0),
                   v=dict(abs=0.0, rel=0.0))])
    assert refresh.check(row) == []
    bad = dict(row, warm_by_epoch=[1])
    bad["forks"] = [dict(row["forks"][0], runs={
        JAX_EIG_REFRESH_TOL: dict(run, finite=False, eighs=[
            dict(eigh, branch="cold", share=0.01)]),
        0.0: dict(run, eighs=[dict(eigh, branch="warm")])})]
    msgs = refresh.check(bad)
    assert len(msgs) == 4
    assert any("not finite" in m for m in msgs)
    assert any("a default eigh took warm" in m for m in msgs)
    assert any("cold refresh at share 0.01" in m for m in msgs)
    assert any("default run took a warm refresh" in m for m in msgs)
