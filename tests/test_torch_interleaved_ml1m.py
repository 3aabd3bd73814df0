"""The reference's ML-1M quality gates for the reference-order ++ sweep
(tests/test_models_ml1m.py:126-144) on the port at dim 8, block 4, on
the CPU: mean NDCG@20 >= 0.2 after 10 epochs (safer2pp_test.cc:99,
ialspp_test.cc:45), and SAFER2++'s mean dual weight within alpha +/- 0.02
after every epoch (safer2pp_test.cc:135)."""

import os

import pytest
import torch

from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, get_model)

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
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


@pytest.mark.parametrize("name,cfg,mean_weight", [
    # safer2_test.cc:17-27
    ("safer2pp", dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                      bandwidth=0.15, xi_iterations=5, pd_iterations=1), 0.3),
    # ialspp_test.cc: uobs 0.1, reg 0.003
    ("ialspp", dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0,
                    stdev=0.1), None),
], ids=["safer2pp", "ialspp"])
def test_interleaved_ml1m_quality_gates(ml1m_port, name, cfg, mean_weight):
    train, dd, fold = ml1m_port
    m = get_model(name, Config(dim=8, block_size=4, block_interleaved=True,
                               **cfg),
                  train.num_users, train.num_items, device="cpu")
    assert not m._loss_lags_one_epoch
    m.initialize(dd)
    for _ in range(10):
        m.train_epoch(dd)
        if mean_weight is not None:
            assert m.get_mean_weight() == pytest.approx(mean_weight,
                                                        abs=0.02)
    assert torch.isfinite(m.state.user_emb).all()
    res = m.evaluate_dataset(fold, k_list=(5, 10, 20, 50, 100))
    assert res.mean_ndcg()[2] >= 0.2
