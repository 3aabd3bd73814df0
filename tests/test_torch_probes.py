"""The port's device probes (``probes/``) on the CPU: the parts that do
not need a GPU. The probes' ``run`` entry points measure a GPU and
refuse anything else."""

import math

import pytest
import torch

from safer2_recommender_tpu_torch import Config, Dataset, DeviceData, get_model
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.ops import woodbury
from safer2_recommender_tpu_torch.probes import bdot as bdot_probe
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


def test_solver_product_shapes_records_the_batched_products():
    shapes = bdot_probe.solver_product_shapes(2, 128, torch.device("cpu"))
    assert shapes, "spd_solve at d = 128 issued no batched product"
    for (sa, sb), count in shapes.items():
        assert sa[0] == sb[0] == 2 and count > 0
        assert sa[2] == sb[1]        # inner dimensions agree
