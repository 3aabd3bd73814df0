"""The benchmark's frozen copies and arithmetic: the MSD draw against its
published totals, FLOP and byte counts by hand, the op classes on a
synthetic trace, and the no-JAX rule."""

import json
import os
import sys
import types

import numpy as np
import pytest

from portbench import run
from portbench.frozen import bounds, opclasses, synth


def test_msd_draw_meets_published_totals():
    cfg = json.load(open(os.path.join(run.HERE, "configs",
                                      "safer2-d512.json")))
    ds = cfg["dataset"]
    assert (ds["users"], ds["items"], ds["interactions"]) == (
        571355, 41140, 33633450)
    hist = synth.history_lengths(np.random.default_rng(2 ** 31 + 99),
                                 ds["users"], ds, synth.msd_loc(ds))
    target = ds["interactions"] / ds["users"]
    assert abs(hist.mean() / target - 1) < 0.01
    assert hist.min() >= ds["min_hist"] and hist.max() <= ds["max_hist"]
    assert ds["users"] - ds["heldout_users"] == 471355
    assert abs(synth.clipped_mean(synth.msd_loc(ds), ds["lognormal_sigma"],
                                  ds["min_hist"], ds["max_hist"])
               / target - 1) < 1e-6


def test_training_set_shape():
    ds = dict(users=400, items=90, interactions=400 * 30, heldout_users=50,
              min_hist=5, max_hist=200, lognormal_sigma=0.9, zipf_exp=0.8)
    users, items, hist = synth.training_set(ds, 5)
    assert users.max() + 1 == 350 and items.max() < 90
    assert users.size == hist[:350].sum()
    again = synth.training_set(ds, 5)
    np.testing.assert_array_equal(again[1], items)


def test_flops_by_hand():
    g = run.load_module("flops", "mf_gramian").epoch_flops
    assert g({"dim": 4}, np.array([1, 2]), np.array([3])) == 6 * 16
    b = run.load_module("flops", "mf_gramian_blocked").epoch_flops
    cfg = {"dim": 128, "block_size": 32}
    # user 10 <= 64 exact: 10 * 128^2; 100 > 64 blocked: 100 * 32 * 128
    assert b(cfg, np.array([10, 100]), np.array([64])) == (
        10 * 128 ** 2 + 100 * 32 * 128 + 64 * 128 ** 2)
    # below dim 128 every row is blocked
    assert b({"dim": 64, "block_size": 32}, np.array([5]),
             np.array([])) == 5 * 32 * 64


def test_chol_inverse_bound_by_hand():
    # n = 1, r = 8: 4 (36 + 8 + 64) = 432 bytes at 3.35 TB/s beats
    # 2 * 512 / 3 FLOP at 67 TFLOP/s
    assert bounds.chol_inverse_ms(1, 8) == pytest.approx(432 / 3.35e12 * 1e3)
    # n = 4096, r = 64: bytes 4 * 4096 * (2080 + 64 + 4096)
    n, r = 4096, 64
    want = max(4 * n * 6240 / 3.35e12, n * 2 * r ** 3 / 3 / 67e12) * 1e3
    assert bounds.chol_inverse_ms(n, r) == pytest.approx(want)
    assert bounds.chol_inverse_ms(n, r) == pytest.approx(0.0305, abs=1e-4)


def test_op_classes_sum_to_the_kernels():
    K = opclasses.KernelRow
    rows = [K("aten::bmm", ((8, 4, 16), (8, 16, 4)), "gemm", 2.0),
            K("aten::bmm", ((8, 4, 16), (8, 16, 1)), "gemv", 0.5),
            K("aten::mm", ((4, 4), (4, 4)), "sgemm", 1.5),
            K("aten::index", ((9,),), "idx", 0.25),
            K("aten::index_put_", ((9,),), "put", 0.125),
            K("aten::_linalg_eigh", (), "syevd", 3.0),
            K("aten::sum", ((4,),), "reduce", 0.75),
            K("aten::copy_", ((4,),), "copy", 0.2),
            K("aten::mul", ((4,), (4,)), "elementwise", 4.0),
            K(None, (), "frt_chol_inverse_kernel<64>", 1.0),
            K(None, (), "Memcpy HtoD", 0.3),
            K(None, (), "mystery", 0.1)]
    got = opclasses.classify(rows)
    assert sum(got.values()) == pytest.approx(sum(r.ms for r in rows))
    assert got["batched Gramian products"] == 2.0
    assert got["batched rhs products"] == 0.5
    assert got["chol_inverse"] == 1.0
    assert got["eigh"] == 3.0
    assert got["dtype and layout copies"] == pytest.approx(0.5)
    assert got[opclasses.CATCH_ALL] == pytest.approx(4.1)
    assert opclasses.union_ms([(0, 2), (1, 3), (5, 6)]) == 4
    assert opclasses.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_no_jax_rule(monkeypatch):
    assert "safer2_recommender_tpu_torch" not in run.forbidden_modules()
    import safer2_recommender_tpu_torch  # noqa: F401
    assert run.forbidden_modules() == [] or "safer2_recommender_tpu_torch" \
        not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "safer2_recommender_tpu.ops",
                        types.ModuleType("safer2_recommender_tpu.ops"))
    assert run.forbidden_modules() == ["safer2_recommender_tpu"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    from portbench.tests import tiny
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc, last, err = tiny.run(run, "safer2-d512.train-msd")
    assert rc != 0 and last is None and "jaxlib" in err


def test_reference_imports_nothing_of_the_port():
    import ast
    for root, _, files in os.walk(os.path.join(run.HERE, "reference")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib",
                                       "safer2_recommender_tpu",
                                       "safer2_recommender_tpu_torch"), (f, n)
