"""The port's data layer against the JAX package's: every bucket array,
permutation, history size and item_reg must be EXACTLY equal (the model
tables are only meaningful relative to the solver order)."""

import gzip
import os

import numpy as np
import pytest
import torch

from safer2_recommender_tpu import Dataset as JDataset
from safer2_recommender_tpu import DeviceData as JDeviceData
from safer2_recommender_tpu import FoldInData as JFoldInData
from safer2_recommender_tpu_torch.data import dataset as tds

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))


def _same(t, j):
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def _same_buckets(tb, jb):
    assert len(tb) == len(jb)
    for t, j in zip(tb, jb):
        _same(t.row_ids, j.row_ids)
        _same(t.col_ids, j.col_ids)
        _same(t.length, j.length)
        assert t.contiguous == j.contiguous
        if j.contiguous:
            assert t.row_start == int(j.row_start)
        else:
            assert t.row_start is None


def _same_dd(tdd, jdd):
    _same_buckets(tdd.by_user, jdd.by_user)
    _same_buckets(tdd.by_item, jdd.by_item)
    for name in ("user_hist_size", "item_hist_size", "item_reg",
                 "user_perm", "item_perm", "user_order", "item_order"):
        _same(getattr(tdd, name), getattr(jdd, name))
    assert (tdd.num_users, tdd.num_items, tdd.nnz) == (
        jdd.num_users, jdd.num_items, jdd.nnz)


def _port(ds):
    return tds.Dataset(ds.user_ids, ds.item_ids)


@pytest.mark.parametrize("kw", [
    {},
    {"growth": 4},
    # a tight budget forces the row-chunked buckets
    {"dim": 64, "memory_budget_bytes": 64 * 64 * 4 * 64},
])
def test_device_data_matches_jax_on_tiny(tiny, kw):
    ds, _ = tiny
    _same_dd(tds.DeviceData.build(_port(ds), device="cpu", **kw),
             JDeviceData.build(ds, **kw))


def test_device_data_matches_jax_on_ml1m(ml1m):
    train, jdd, _ = ml1m
    _same_dd(tds.DeviceData.build(_port(train), device="cpu"), jdd)


def test_fold_in_data_matches_jax_on_ml1m(ml1m):
    train, _, jfold = ml1m
    val_tr = tds.Dataset.from_csv(os.path.join(ML1M_DIR, "validation_tr.csv"))
    val_te = tds.Dataset.from_csv(os.path.join(ML1M_DIR, "validation_te.csv"))
    fold = tds.FoldInData.build(val_tr, val_te, num_items=train.num_items,
                                device="cpu")
    _same_buckets(fold.by_user, jfold.by_user)
    for name in ("excl", "gt", "gt_len", "hist_size"):
        _same(getattr(fold, name), getattr(jfold, name))
    assert (fold.n_eval, fold.n_pad, fold.num_items, fold.nnz) == (
        jfold.n_eval, jfold.n_pad, jfold.num_items, jfold.nnz)


def test_fold_in_data_without_ground_truth_matches_jax(tiny):
    # the shape recommend() builds: histories only, empty test set
    ds, _ = tiny
    empty = np.zeros(0, np.int32)
    fold = tds.FoldInData.build(_port(ds), tds.Dataset(empty, empty),
                                num_items=ds.num_items, device="cpu",
                                dim=8)
    jfold = JFoldInData.build(ds, JDataset(empty, empty),
                              num_items=ds.num_items, dim=8)
    _same_buckets(fold.by_user, jfold.by_user)
    for name in ("excl", "gt", "gt_len", "hist_size"):
        _same(getattr(fold, name), getattr(jfold, name))


def test_from_csv_native_and_gz_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    u = rng.integers(0, 50, 300)
    i = rng.integers(0, 30, 300)
    text = "uid,sid\n" + "".join(f"{a},{b}\n" for a, b in zip(u, i))
    plain = tmp_path / "plain.csv"
    plain.write_text(text)
    with gzip.open(tmp_path / "zipped.csv.gz", "wt") as f:
        f.write(text)
    for path in (str(plain), str(tmp_path / "zipped.csv")):
        got = tds.Dataset.from_csv(path)
        want = JDataset.from_csv(path)
        np.testing.assert_array_equal(got.user_ids, want.user_ids)
        np.testing.assert_array_equal(got.item_ids, want.item_ids)
        assert (got.num_users, got.num_items) == (want.num_users,
                                                  want.num_items)


def test_native_reader_builds_from_the_jax_source():
    from safer2_recommender_tpu_torch import native

    # the port's own copy of the JAX package's source (csrc/csv_reader.cc)
    assert native.CSV_READER_SRC == os.path.join(native.CSRC_DIR,
                                                 "csv_reader.cc")
    if native.load_csv_reader() is None:
        pytest.skip("no C++ toolchain to build the native reader")
    out = native.build_shared("frt_io", [native.CSV_READER_SRC],
                              native.CSV_READER_FLAGS)
    assert out.startswith(native.BUILD_DIR)
    assert os.path.exists(out)


def test_bucket_edges_reject_a_flat_ladder():
    with pytest.raises(ValueError):
        tds._bucket_edges(64, 8, 1)


@pytest.mark.parametrize("seed", [0, 3])
def test_powerlaw_dataset_matches_jax(seed, tmp_path):
    # the port's numpy copy of data/synth.py gives the same tuples for a
    # seed, so the two packages run the same synthetic workload
    from safer2_recommender_tpu.data import synth as jsynth
    from safer2_recommender_tpu_torch.data import synth as tsynth

    got = tsynth.powerlaw_dataset(500, 300, seed=seed)
    want = jsynth.powerlaw_dataset(500, 300, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    tsynth.write_csv(str(tmp_path / "t.csv"), *got)
    jsynth.write_csv(str(tmp_path / "j.csv"), *want)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    ds = tds.Dataset.from_csv(str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(ds.user_ids, got[0])
