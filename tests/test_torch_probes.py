"""The port's device probes (``probes/``) on the CPU: the parts that do
not need a GPU. The probes' ``run`` entry points measure a GPU and
refuse anything else."""

import math

import pytest
import torch

import chip_smoke
from safer2_recommender_tpu_torch import Config, Dataset, DeviceData, get_model
from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.ops import bdot as bdot_op
from safer2_recommender_tpu_torch.ops import block_chol, woodbury
from safer2_recommender_tpu_torch.probes import bdot as bdot_probe
from safer2_recommender_tpu_torch.probes import bdot_design
from safer2_recommender_tpu_torch.probes import chol_inverse as chol_probe
from safer2_recommender_tpu_torch.probes import epoch_profile, roofline


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0.0, 1.0), (2.0, 3.5)], 2.5),            # disjoint
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),            # overlapping
    ([(0.0, 5.0), (1.0, 2.0), (4.0, 6.0)], 6.0),  # nested, then overlapping
    ([(3.0, 4.0), (0.0, 1.0), (1.0, 2.0)], 3.0),  # unsorted, touching
])
def test_busy_ms_counts_overlapping_time_once(spans, want):
    assert epoch_profile.busy_ms(spans) == pytest.approx(want, abs=1e-12)


def test_phase_ms_times_every_phase_and_leaves_the_state():
    # dim 128 takes the Woodbury and rotated paths, as dim 512 does
    ds = Dataset(*powerlaw_dataset(300, 200, mean_hist=30, seed=1))
    dd = DeviceData.build(ds, device="cpu", dim=128)
    cfg = Config(dim=128, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                 bandwidth=0.15, seed=0)
    model = get_model("safer2", cfg, ds.num_users, ds.num_items,
                      device="cpu")
    model.initialize(dd)
    model.train_epochs(dd, 1)
    before = model.state
    woodbury.reset_solve_paths()
    ms = epoch_profile.phase_ms(model, dd)
    assert list(ms) == ["epoch.loss", "epoch.xi", "epoch.z",
                        "epoch.u_sweep", "epoch.v_sweep", "epoch.gram",
                        "epoch"]
    assert all(math.isfinite(v) and v >= 0 for v in ms.values())
    assert woodbury.SOLVE_PATHS["woodbury"] > 0
    assert model.state is before


def test_workload_configs_are_the_published_ones():
    ml, msd = epoch_profile.ml1m_config(), epoch_profile.msd_config()
    assert (ml.dim, ml.uobs_weight, ml.l2_reg, ml.alpha, ml.bandwidth) == (
        512, 0.004, 0.004, 0.3, 0.15)
    assert (msd.dim, msd.uobs_weight, msd.l2_reg, msd.alpha, msd.bandwidth,
            msd.use_snr, msd.sampling_ratio) == (
        512, 0.0004, 0.0012, 0.3, 0.1, True, 0.1)
    with pytest.raises(ValueError, match="unknown workload"):
        epoch_profile.workload("msd", "cpu")


def test_bdot_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        bdot_probe.run(device="cpu")


def test_bdot_design_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        bdot_design.run(device="cpu")


def test_solver_product_shapes_records_the_batched_products():
    shapes = bdot_probe.solver_product_shapes(2, 128, torch.device("cpu"))
    assert shapes, "spd_solve at d = 128 issued no batched product"
    for (sa, sb), count in shapes.items():
        assert sa[0] == sb[0] == 2 and count > 0
        assert sa[2] == sb[1]        # inner dimensions agree


@pytest.mark.parametrize("n, r, nbytes, by", [
    (928, 64, 928 * 4 * (64 * 65 // 2 + 64 + 64 * 64), "bytes"),
    (4096, 8, 4096 * 4 * (8 * 9 // 2 + 8 + 8 * 8), "bytes"),
])
def test_chol_inverse_bound_counts_each_byte_once(n, r, nbytes, by):
    # the lower triangle of a and the ridge read once, out written once;
    # 2 r^3 / 3 FLOP per system; at r <= 64 bytes bound it
    b = chol_probe.bound(n, r)
    assert (b["bytes"], b["bound_by"]) == (nbytes, by)
    assert b["flop"] == pytest.approx(n * 2 * r ** 3 / 3)
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


@pytest.mark.parametrize("n_dots, products", [
    (0, 0), (1, 1), (3, 2), (7, 3), (8, 4), (13, 5)])
def test_bdot_bound_counts_the_fewest_products(n_dots, products):
    # x^(n_dots + 1) by repeated squaring, e.g. x^9 = ((x^2)^2)^2 x
    assert bdot_probe.products_needed(n_dots) == products


@pytest.mark.parametrize("h, precision, bound_ms, by", [
    (128, "highest", 0.4165, "operations"),   # 3 TF32 passes at 495 TFLOP/s
    (128, "default", 0.1603, "bytes"),
    (64, "highest", 0.0521, "operations"),
    (64, "default", 0.0401, "bytes"),
    (32, "highest", 0.0100, "bytes"),
    (32, "default", 0.0100, "bytes"),
])
def test_bdot_bound_counts_the_tensor_core_rate(h, precision, bound_ms, by):
    # x read and out written once; the 4 products of x^9 at the faster of
    # 3 TF32 passes and f32 FMA ("highest") or one TF32 pass ("default")
    b = bdot_probe.bound(4096, h, 8, precision)
    assert b["bytes"] == 2 * 4 * 4096 * h * h
    assert b["flop"] == 2.0 * 4096 * h ** 3 * 4
    assert (round(b["bound_ms"], 4), b["bound_by"]) == (bound_ms, by)


def test_bdot_design_variants_apply_to_the_kernel_source():
    # each variant replaces text that bdot.cu holds exactly once
    with open(bdot_op._SRC) as f:
        src = f.read()
    texts = bdot_design.variants(src)
    assert list(texts) == ["kernel", *bdot_design.SUBSTITUTIONS]
    assert texts["kernel"] == src
    for name in bdot_design.SUBSTITUTIONS:
        assert texts[name] != src, name
    with pytest.raises(ValueError, match="exactly once"):
        bdot_design.variants(src.replace("tf32_bits(v)", "tf32_bits(w)"))


def test_probe_bound_takes_the_arithmetic_rate():
    assert probes.bound(0, 67e9)["bound_ms"] == pytest.approx(1.0)
    assert probes.bound(0, 495e9, probes.TF32_TENSOR_FLOP_PER_S)[
        "bound_ms"] == pytest.approx(1.0)


@pytest.mark.parametrize("r, sizes", [(8, [0, 1, 15, 17, 4097]),
                                      (32, [0, 1, 3, 5, 4097]),
                                      (64, [0, 1, 2, 4097])])
def test_chol_inverse_ragged_sizes_straddle_one_block(r, sizes):
    assert chol_probe.ragged_sizes(r) == sizes


def test_chol_inverse_errors_read_the_hard_systems():
    gen = torch.Generator().manual_seed(0)
    a, ridge = chol_probe.hard_batch(gen, 6, 16, "cpu")
    want = block_chol.chol_inverse_small_ref(a, ridge)
    e = chol_probe.errors(want.clone(), want)
    assert e["finite"] and e["upper_zero"] and e["eye_err"] == 0.0
    assert e["max_rel_err"] == e["rank_def_rel_err"] == 0.0
    bad = want.clone()
    bad[3, 0, 5] = 1e-3                   # above the diagonal
    bad[1] *= 1.01                        # the rank-deficient system
    e = chol_probe.errors(bad, want)
    assert not e["upper_zero"]
    assert e["rank_def_rel_err"] == pytest.approx(0.01, rel=1e-4)


def test_chol_inverse_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        chol_probe.run(device="cpu")


def test_launch_histogram_counts_launches_below_one_wave():
    shapes = [(928, 64, 64), (21, 8, 8), (21, 8, 8), (6000, 32, 32)]
    hist = probes.launch_histogram(shapes, {8: 100, 32: 5280, 64: 1056})
    assert hist[8] == {"launches": 2, "below_one_wave": 2, "one_wave": 100,
                       "n_bins": {"[16, 32)": 2}}
    assert hist[32]["below_one_wave"] == 0
    assert hist[64]["n_bins"] == {"[512, 1024)": 1}
    assert chip_smoke.most_frequent(shapes) == (21, 8, 8)


# ---- op-class accounting (probes/epoch_profile.py) ----------------------


@pytest.mark.parametrize("op, shapes, kernel, want", [
    ("aten::index", ((64, 512), (128, 40)), "index_elementwise_kernel",
     "gather (slab rows)"),
    ("aten::index_put_", ((50000, 512),), "index_put_kernel",
     "scatter (writeback)"),
    ("aten::index_copy_", ((50000,),), "index_copy_kernel",
     "scatter (writeback)"),
    (None, (), "frt_chol_inverse_f32<64>", "chol_inverse"),
    ("aten::_linalg_eigh", ((512, 512),), "syevd_kernel", "eigh"),
    ("aten::bmm", ((128, 512, 40), (128, 40, 512)), "sgemm_128x128_tn",
     "batched Gramian products"),
    ("aten::bmm", ((128, 40, 512), (128, 512, 1)), "gemv2T_kernel",
     "batched rhs products"),
    ("aten::baddbmm", ((128, 1, 64), (128, 1, 64), (128, 64, 64), (), ()),
     "gemv_kernel", "batched rhs products"),
    ("aten::mm", ((50000, 512), (512, 512)), "sgemm_128x64_nn",
     "other GEMMs"),
    ("aten::sum", ((128, 40, 512), ()), "reduce_kernel", "reductions"),
    ("aten::copy_", ((128, 40, 512), (128, 40, 512)), "elementwise_kernel",
     "dtype and layout copies"),
    ("aten::to", (), "Memcpy HtoD (Pageable -> Device)",
     "dtype and layout copies"),
    ("aten::mul", ((128, 40, 512), (128, 40, 1)),
     "elementwise_kernel<128, 2, BinaryFunctor<float>>",
     "elementwise and the rest"),
    (None, (), "some_kernel", "elementwise and the rest"),
])
def test_op_class_sorts_a_kernel_by_its_launching_op(op, shapes, kernel,
                                                     want):
    assert epoch_profile.op_class(op, shapes, kernel) == want


def test_classify_keeps_the_sum_and_names_the_catch_all():
    R = epoch_profile.KernelRow
    site = "ops/assemble.py(65): gather_history"
    rows = [R("aten::index", ((9, 4), (3, 5)), site, "index_kernel", 2.0),
            R("aten::mul", ((3, 5, 4), (3, 5, 1)), site, "mul_kernel", 1.5),
            R("aten::mul", ((7, 5, 4), (7, 5, 1)), site, "mul_kernel", 2.5),
            R("aten::mul", ((7, 4), (7, 4)), "models/common.py(700): loss",
              "mul_kernel", 0.25),
            R("aten::bmm", ((3, 4, 5), (3, 5, 4)), site, "gemm", 3.0),
            R(None, (), "", "frt_chol_inverse_f32", 0.75, 3)]
    t = epoch_profile.classify(rows)
    assert list(t["classes"]) == list(epoch_profile.CLASSES)
    assert t["total_ms"] == pytest.approx(10.0)
    assert sum(v["ms"] for v in t["classes"].values()) == pytest.approx(10.0)
    assert sum(v["share"] for v in t["classes"].values()) == \
        pytest.approx(1.0)
    assert t["classes"]["chol_inverse"] == {"ms": 0.75, "launches": 3,
                                            "share": 0.075}
    assert t["unparented_ms"] == pytest.approx(0.75)
    rest = t["classes"][epoch_profile.CATCH_ALL]
    assert (rest["ms"], rest["launches"]) == (4.25, 3)
    assert t["catch_all"] == [(4.25, 3, "aten::mul: mul_kernel")]
    # split by launching op, site and broadcast pattern; the example is
    # the shapes that took the most time
    assert t["elementwise"][0] == (
        4.0, 2, "aten::mul", site, "[n, n, n] x [n, n, 1]",
        "[[7, 5, 4], [7, 5, 1]]")
    assert t["elementwise"][1][:5] == (
        0.25, 1, "aten::mul", "models/common.py(700): loss",
        "[n, n] x [n, n]")
    lines = epoch_profile.describe_classes(
        dict(t, kernel_ms=10.0, gap=0.0, epochs=2))
    # the totals, a line per class, the catch-all's one constituent and
    # its two splits under their headings
    assert "+0.0000%" in lines[0]
    assert len(lines) == 1 + len(epoch_profile.CLASSES) + 2 + 3


def test_kernel_rows_link_kernels_to_ops_and_keep_the_rest():
    # fake profiler events: an aten op under a site annotation launched
    # two kernels, an op inside eigh one, and one kernel (the ctypes
    # chol_inverse launch) has no aten op; a non-op event that shares an
    # op's correlation id holds its kernels too, and counts for nothing
    from types import SimpleNamespace as E

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Kernel

    def dev(name, us):
        return E(name=name, device_type=DeviceType.CUDA,
                 is_user_annotation=False,
                 time_range=E(start=0.0, end=us))

    def cpu(name, id, kernels=(), parent=None, shapes=()):
        return E(name=name, id=id, cpu_parent=parent, kernels=list(kernels),
                 device_type=DeviceType.CPU, input_shapes=list(shapes))

    site = cpu("site: ops/assemble.py(68): gather_history", 1)
    mul = cpu("aten::mul", 2, [Kernel("mul_kernel", 0, 1500.0),
                               Kernel("mul_kernel", 0, 500.0)], site,
              [[3, 5, 4], [3, 5, 1]])
    lazy = cpu("Lazy Function Loading", 2, [Kernel("mul_kernel", 0, 500.0)])
    eigh = cpu("aten::_linalg_eigh", 3, parent=site)
    copy = cpu("aten::copy_", 4, [Kernel("copy_k", 0, 10.0)], eigh,
               [[4], [4]])
    events = [site, mul, lazy, eigh, copy, dev("mul_kernel", 1500.0),
              dev("mul_kernel", 500.0), dev("copy_k", 10.0),
              dev("frt_chol_inverse_f32", 250.0),
              dev("frt_chol_inverse_f32", 250.0),
              dev("Buffer Flush", 9e9)]
    rows = epoch_profile.kernel_rows(events)
    R = epoch_profile.KernelRow
    assert rows == [
        R("aten::mul", ((3, 5, 4), (3, 5, 1)),
          "ops/assemble.py(68): gather_history", "mul_kernel", 1.5),
        R("aten::mul", ((3, 5, 4), (3, 5, 1)),
          "ops/assemble.py(68): gather_history", "mul_kernel", 0.5),
        R("aten::_linalg_eigh", ((4,), (4,)),
          "ops/assemble.py(68): gather_history", "copy_k", 0.01),
        R(None, (), "", "frt_chol_inverse_f32", 0.5, 2)]
    t = epoch_profile.classify(rows)
    assert t["total_ms"] == pytest.approx(2.51)
    assert t["classes"]["eigh"]["ms"] == pytest.approx(0.01)
    assert t["classes"]["chol_inverse"]["launches"] == 2
    # a kernel linked to an op but missing from the device events stays
    # with its op, so the rows sum to more than the device events
    short = epoch_profile.kernel_rows(events[:6])
    assert [(r.kernel, r.ms) for r in short] == [
        ("mul_kernel", 1.5), ("mul_kernel", 0.5), ("copy_k", 0.01)]


def test_profiled_torch_calls_carry_the_ports_calling_line():
    # a real (CPU) profile of one SAFER2 epoch under the site annotation:
    # the gather's mask product is named by its line in ops/assemble.py
    import inspect
    import os

    from torch.profiler import ProfilerActivity, profile

    from safer2_recommender_tpu_torch.ops import assemble

    ds = Dataset(*powerlaw_dataset(300, 200, mean_hist=30, seed=1))
    dd = DeviceData.build(ds, device="cpu", dim=16)
    model = get_model("safer2", Config(dim=16, bandwidth=0.15), ds.num_users,
                      ds.num_items, device="cpu")
    model.initialize(dd)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) \
            as prof, epoch_profile._Sites():
        model.train_epochs(dd, 1)
    src, first = inspect.getsourcelines(assemble.gather_history_extra)
    line = first + next(i for i, text in enumerate(src)
                        if "* mask[..., None]" in text)
    sites = {epoch_profile._site(e) for e in prof.events()
             if e.name == "aten::mul"}
    assert f"ops{os.sep}assemble.py({line}): gather_history_extra" in sites
    assert "" not in sites


def test_epoch_profile_takes_a_model_name_and_refuses_the_cpu():
    assert epoch_profile.main(["safer2pp", "synth50k"]) == 1
    with pytest.raises(SystemExit):
        epoch_profile.main(["no_such_model"])


# ---- roofline (probes/roofline.py) --------------------------------------


def test_roofline_flop_counts_are_the_jax_scripts():
    # the FLOP argument of each measure(...) call of
    # scripts/profile_roofline.py, evaluated at its sizes
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_roofline.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    sizes = {"d": 4096, "n": 928, "dc": 256}
    script = {ast.literal_eval(c.args[0]): eval(compile(
        ast.Expression(c.args[5]), path, "eval"), {}, sizes)
        for c in ast.walk(tree) if isinstance(c, ast.Call)
        and getattr(c.func, "id", None) == "measure"}
    assert script == {
        "matmul 4096 f32": roofline.matmul_flop(),
        "matmul 4096 bf16": roofline.matmul_flop(),
        "chol [928,256,256]": roofline.chol_flop(),
        "trisolve [928,256]": roofline.trisolve_flop()}
    assert (roofline.D, roofline.N, roofline.DC) == (4096, 928, 256)


def test_roofline_probe_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.run(device="cpu")


def test_serving_ab_draws_server50k_requests_and_times_a_server(monkeypatch):
    # the A/B probe's requests are chip_smoke's [server50k] draws, and its
    # Server pass at dim 128 (a fold-in split at 64) serves every user
    import numpy as np

    from safer2_recommender_tpu_torch.probes import scale, serving_ab

    for name, value in (("LONGEST", 20), ("RANDOM", 60), ("SMALL", 16),
                        ("ROUNDS", 2), ("P50_REPEATS", 3)):
        monkeypatch.setattr(serving_ab, name, value)
    wl = scale.build(600, 300, 128, "cpu")
    batches, b64 = serving_ab.requests(wl.ds)
    longest, _ = chip_smoke.longest_histories(wl.ds, 20)
    rng = np.random.default_rng(chip_smoke.SERVE_SEED)
    want = [longest] + chip_smoke.user_batches(wl.ds, rng, [60])
    want64 = chip_smoke.user_batches(wl.ds, rng, [16])[0]
    for got, ref in zip(batches + [b64], want + [want64]):
        np.testing.assert_array_equal(got.user_ids, ref.user_ids)
        np.testing.assert_array_equal(got.item_ids, ref.item_ids)
    model = scale.train(wl, "safer2", epochs=0)["model"]
    r = serving_ab.server50k(model, batches, b64)
    assert r["batch_users"] == [20, 60]
    assert all(ms > 0 for ms in r["batch_ms"]) and r["users_per_s"] > 0
    assert r["programs"] >= r["programs_after_batches"] >= 1


@pytest.mark.parametrize("change_ms, verdict", [
    ([50.0] * 10, "change better"),
    ([50.0] * 8 + [90.0] * 2, "not resolved"),
    ([70.0] * 10, "parent better"),
])
def test_serving_ab_compare_calls_a_side_only_on_nine_tenths(change_ms,
                                                             verdict):
    from safer2_recommender_tpu_torch.probes import serving_ab

    def run(ms):
        srv = {"batch_ms": [40.0, ms], "users_per_s": 1280 / (40 + ms) * 1e3,
               "p50_ms_batch64": 1.7}
        return {"server50k_safer2": srv, "server50k_safer2pp": srv,
                "serve_msd": {"server": {"p50_ms": 55.0},
                              "exact": {"best_ms": 35.0}}}

    parent = [59.0 + 0.1 * i for i in range(10)]
    lines = serving_ab.compare([(run(p), run(c))
                                for p, c in zip(parent, change_ms)])
    mixed = [x for x in lines if x.startswith("safer2 1,024 random ms")]
    assert mixed[0].endswith(verdict)
    # equal readings in every pair: never a verdict
    assert all(x.endswith("not resolved") for x in lines
               if "p50" in x or "longest" in x or "exact" in x)
