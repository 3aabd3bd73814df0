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
from safer2_recommender_tpu_torch.probes import epoch_profile


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
    assert list(ms) == ["loss", "xi", "z", "eigh_u", "U_incl_eigh",
                        "V_incl_eigh", "gram"]
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
