"""The reference's ML-1M quality gates (tests/test_models_ml1m.py:39-123)
for the five models beside SAFER2, on the port at dim 8 on the CPU:
mean NDCG@20 >= 0.2 after 10 epochs (CVaR-MF: 50), and SAFER2++'s mean
dual weight within alpha +/- 0.02 after every epoch."""

import os

import pytest
import torch

from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, get_model)

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))

# reference safer2_test.cc:17-27 and ials_test.cc
_ML1M_SAFER = dict(dim=8, uobs_weight=0.004, l2_reg=0.004, stdev=0.1,
                   alpha=0.3, bandwidth=0.15, xi_iterations=5,
                   pd_iterations=1)
_ML1M_IALS = dict(dim=8, uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0,
                  stdev=0.1)


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


@pytest.fixture(scope="module")
def ml1m_port():
    train = Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    val_tr = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_tr.csv"))
    val_te = Dataset.from_csv(os.path.join(ML1M_DIR, "validation_te.csv"))
    return (train, DeviceData.build(train, device="cpu"),
            FoldInData.build(val_tr, val_te, num_items=train.num_items,
                             device="cpu"))


@pytest.mark.parametrize("name,cfg,epochs,mean_weight", [
    # ials_test.cc / ialspp_test.cc: uobs 0.1, reg 0.003
    ("ials", _ML1M_IALS, 10, None),
    ("ialspp", dict(_ML1M_IALS, block_size=4), 10, None),
    # erm_mf_test.cc: uobs 0.004, reg 0.005
    ("erm_mf", dict(dim=8, uobs_weight=0.004, l2_reg=0.005, stdev=0.1,
                    alpha=0.3), 10, None),
    # cvar_mf_test.cc:17-25: uobs 0.008, reg 0.002, stepsize 0.4, 50
    # epochs. Subgradient CVaR-MF at dim 8 sits at the gate (the JAX
    # package pins a mid-spread seed for the same reason); the port's
    # generator draws other tables, so its own seed is pinned here.
    ("cvar_mf", dict(dim=8, uobs_weight=0.008, l2_reg=0.002, stdev=0.1,
                     alpha=0.3, stepsize=0.4, seed=2), 50, None),
    ("safer2pp", dict(_ML1M_SAFER, block_size=4), 10, 0.3),
    # SNR and Epanechnikov variants (safer2pp_test.cc:37-86 analogues)
    ("safer2pp", dict(_ML1M_SAFER, block_size=4, use_snr=True,
                      sampling_ratio=0.5), 10, 0.3),
    ("safer2pp", dict(_ML1M_SAFER, block_size=4, bandwidth=0.7,
                      use_epanechnikov=True), 10, 0.3),
], ids=["ials", "ialspp", "erm_mf", "cvar_mf", "safer2pp", "safer2pp-snr",
        "safer2pp-epanechnikov"])
def test_ml1m_quality_gates(ml1m_port, name, cfg, epochs, mean_weight):
    train, dd, fold = ml1m_port
    m = get_model(name, Config(**cfg), train.num_users, train.num_items,
                  device="cpu")
    m.initialize(dd)
    for _ in range(epochs):
        m.train_epoch(dd)
        if mean_weight is not None:
            assert m.get_mean_weight() == pytest.approx(mean_weight,
                                                        abs=0.02)
    res = m.evaluate_dataset(fold, k_list=(5, 10, 20, 50, 100))
    assert res.mean_ndcg()[2] >= 0.2
