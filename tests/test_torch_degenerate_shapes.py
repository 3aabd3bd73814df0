"""Degenerate shapes in the port (the counterpart of
tests/test_degenerate_shapes.py): every model trains, evaluates,
recommends and serves through the ``Server`` on pathological datasets
without crashing or producing non-finite state. The bucketed layout's
edge machinery (width-1 buckets, single-row buckets, all-gap sides,
n_pad > n_real) is what only these shapes exercise."""

import numpy as np
import pytest
import torch

from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, Server, get_model)

CASES = {
    "single_tuple": ([0], [0]),
    "one_user_many_items": ([0] * 9, list(range(9))),
    "one_item_many_users": (list(range(9)), [0] * 9),
    "big_id_gaps": ([0, 50, 99, 99], [0, 7, 7, 63]),
    "two_by_two": ([0, 0, 1, 1], [0, 1, 0, 1]),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["ials", "ialspp", "erm_mf", "cvar_mf",
                                  "safer2", "safer2pp"])
def test_degenerate_dataset(name, case):
    u, i = CASES[case]
    ds = Dataset(np.asarray(u, np.int32), np.asarray(i, np.int32))
    dd = DeviceData.build(ds, device="cpu")
    cfg = Config(dim=4, block_size=2, bandwidth=0.3, alpha=0.3,
                 xi_iterations=2)
    m = get_model(name, cfg, ds.num_users, ds.num_items, device="cpu")
    m.initialize(dd)
    m.train_epochs(dd, 2)
    for leaf in (m.state.user_emb, m.state.item_emb, m.state.user_loss,
                 m.state.dual_weight):
        assert bool(torch.isfinite(leaf).all()), (name, case)
    fold = FoldInData.build(ds, ds, num_items=ds.num_items, device="cpu")
    res = m.evaluate_dataset(fold, k_list=(1, 2))
    assert np.isfinite(res.mean_ndcg()).all()
    users, recs = m.recommend(ds, k=1)
    assert (recs >= 0).all() and (recs < ds.num_items).all()
    susers, srecs = Server(m, k=1).recommend(ds)
    np.testing.assert_array_equal(susers, users)
    np.testing.assert_array_equal(srecs, recs)
