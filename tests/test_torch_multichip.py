"""The multi-rank probes (``probes/multichip.py``: the counterparts of
scripts/bench_multichip.py, bench_virtual_scaling.py and
audit_collectives.py) and ``parallel.mesh.placement`` on the CPU, at tiny
sizes: gloo ranks, no time of the card."""

import numpy as np
import pytest
import torch

from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.probes import multichip


def test_workloads_are_the_jax_scripts():
    # scripts/bench_multichip.py:31-32 and bench_virtual_scaling.py:53-58
    spec, cfg = multichip.sweep_spec()
    assert spec == ("ml1m",)
    assert (cfg.dim, cfg.uobs_weight, cfg.l2_reg, cfg.alpha, cfg.bandwidth,
            cfg.xi_iterations, cfg.pd_iterations) == (
        32, 0.004, 0.004, 0.3, 0.15, 5, 1)
    assert multichip.SWEEP_SIZES == (1, 2, 4, 8)
    spec, cfg = multichip.virtual_spec()
    assert spec == ("powerlaw", 8192, 4000, 40, 0)
    assert (cfg.dim, cfg.uobs_weight, cfg.l2_reg, cfg.alpha, cfg.bandwidth,
            cfg.xi_iterations, cfg.pd_iterations) == (
        256, 0.002, 0.002, 0.3, 0.18, 5, 1)
    # scripts/audit_collectives.py:33-35, :51-52
    assert (multichip.AUDIT_RANKS, multichip.AUDIT_USERS,
            multichip.AUDIT_ITEMS, multichip.AUDIT_DIM) == (8, 8000, 2000, 64)
    assert multichip.AUDIT_MODELS == ("safer2", "safer2pp", "ials")


def test_traffic_difference_drops_empty_kinds():
    a = {"all-gather": (3, 300), "broadcast": (1, 10)}
    b = {"all-gather": (1, 100), "broadcast": (1, 10)}
    assert multichip._minus(a, b) == {"all-gather": (2, 200)}


def test_placement_puts_ranks_beyond_the_cards_on_the_first_over_gloo(
        monkeypatch):
    assert mesh_lib.placement(8, "cpu") == ("cpu", None)
    assert not mesh_lib.shares_a_card(8, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert mesh_lib.placement(4, "cuda") == ("cuda", None)
    assert mesh_lib.placement(8, "cuda") == ("cuda:0", "gloo")
    assert mesh_lib.placement(8, "cuda:1") == ("cuda:1", None)
    assert mesh_lib.shares_a_card(8, "cuda:0")
    assert not mesh_lib.shares_a_card(1, "cuda:0")
    assert not mesh_lib.shares_a_card(4, "cuda")


def test_audit_on_eight_ranks_counts_one_gather_per_sweep():
    r = multichip.audit("cpu", users=600, items=150, dim=16)
    assert r["ranks"] == 8 and not r["shared"]
    assert multichip.audit_faults(r) == []
    assert set(r["models"]) == set(multichip.AUDIT_MODELS)
    for m in r["models"].values():
        # the fold-in shares the solved eval rows once, scoring shares
        # the per-user metrics once
        assert m["fold_in"] == {"all-gather": (1, m["fold_in"]["all-gather"][1])}
        assert list(m["scoring"]) == ["all-gather"]
    text = multichip.describe_audit(r, "cpu")
    assert text.count("U+V tables") == 3 and "8 rank(s) on cpu" in text
    # a rank whose count differs is a fault
    r["by_rank"][3] = {}
    assert multichip.audit_faults(r) == ["rank 3 counted other traffic "
                                         "than rank 0"]


def test_timed_worlds_train_the_same_model_and_state_no_speedup():
    worlds = multichip.virtual("cpu", users=300, dim=8, epochs=2)
    assert [w["ranks"] for w in worlds] == [1, 8]
    losses = []
    for w in worlds:
        ranks = w["by_rank"]
        assert [x["world_size"] for x in ranks] == [w["ranks"]] * w["ranks"]
        assert all(x["finite"] and len(x["epoch_ms"]) == 2 for x in ranks)
        assert len({x["digest"] for x in ranks}) == 1
        losses.append(ranks[0]["loss"])
        line = multichip.describe_timed("virtual", w, "cpu")
        assert "bitwise equal" in line and f"{w['ranks']} rank(s) on cpu" in line
        assert "speedup" not in line and "efficiency" not in line
    np.testing.assert_allclose(losses[1], losses[0], rtol=5e-3)


def test_a_shared_card_is_named_in_every_line():
    w = dict(ranks=8, shared=True, by_rank=[dict(
        epoch_ms=[1.0, 2.0], loss=0.5, mean_dual=0.3, launches=4,
        digest="x")] * 8)
    line = multichip.describe_timed("sweep", w, "cuda")
    assert "8 ranks sharing one card (function check, not scaling)" in line


def test_main_refuses_an_unknown_part():
    with pytest.raises(SystemExit):
        multichip.main(["--part", "nope"])
