"""The port's data-parallel layout against the JAX package's, in one
process (no process group): each rank's bucket arrays against the JAX
mesh build's shard on that device, the audit counter's arithmetic, the
evaluation chunk under S shards, the Server's rungs and the CLI's
``--mesh`` refusal. The collectives themselves run in
tests/test_torch_distributed.py (two spawned gloo ranks)."""

import logging

import jax
import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.models.base import Recommender as JaxRecommender
from safer2_recommender_tpu.parallel import get_mesh as jax_get_mesh
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, Server, get_model)
from safer2_recommender_tpu_torch.ops import assemble
from safer2_recommender_tpu_torch.parallel import audit, mesh as mesh_lib
from safer2_recommender_tpu_torch.parallel import Mesh

CPU = torch.device("cpu")


def _mesh(s: int, r: int) -> Mesh:
    return Mesh(world_size=s, rank=r, device=CPU)


def _jax_mesh(s: int):
    if jax.device_count() < s:
        pytest.skip(f"needs {s} JAX devices")
    return jax_get_mesh(jax.devices()[:s])


def _shards(arr) -> list:
    """A row-sharded jax.Array's per-device blocks in row order."""
    shards = sorted(arr.addressable_shards,
                    key=lambda sh: sh.index[0].start or 0)
    return [np.asarray(sh.data) for sh in shards]


def _port(ds) -> Dataset:
    return Dataset(ds.user_ids, ds.item_ids)


def _split(ds):
    return (Dataset(ds.user_ids[::2], ds.item_ids[::2]),
            Dataset(ds.user_ids[1::2], ds.item_ids[1::2]))


@pytest.mark.parametrize("s", [2, 8])
def test_device_data_shards_equal_the_jax_mesh_build(tiny, s):
    ds, _ = tiny
    jdd = jx.DeviceData.build(ds, mesh=_jax_mesh(s))
    for r in range(s):
        dd = DeviceData.build(_port(ds), device="cpu", mesh=_mesh(s, r))
        assert dd.mesh.rank == r
        for side in ("by_user", "by_item"):
            jb, tb = getattr(jdd, side), getattr(dd, side)
            assert len(jb) == len(tb)
            for jbk, tbk in zip(jb, tb):
                # the counterpart of test_sharded_bucket_row_counts_divisible
                assert jbk.row_ids.shape[0] % s == 0
                assert tbk.n_rows * s == jbk.row_ids.shape[0]
                for f in ("row_ids", "col_ids", "length"):
                    np.testing.assert_array_equal(
                        getattr(tbk, f).numpy(), _shards(getattr(jbk, f))[r])
        # the per-id vectors stay whole on every rank
        for f in ("user_hist_size", "item_hist_size", "item_reg",
                  "user_perm", "item_order"):
            np.testing.assert_array_equal(getattr(dd, f).numpy(),
                                          np.asarray(getattr(jdd, f)))


@pytest.mark.parametrize("s", [2, 8])
def test_fold_in_data_shards_equal_the_jax_mesh_build(tiny, s):
    ds, _ = tiny
    tr, te = _split(ds)
    jtr = jx.Dataset(tr.user_ids, tr.item_ids)
    jte = jx.Dataset(te.user_ids, te.item_ids)
    jf = jx.FoldInData.build(jtr, jte, num_items=ds.num_items,
                             mesh=_jax_mesh(s))
    for r in range(s):
        f = FoldInData.build(tr, te, num_items=ds.num_items, device="cpu",
                             mesh=_mesh(s, r))
        assert (f.n_pad, f.n_eval) == (jf.n_pad, jf.n_eval)
        assert len(f.by_user) == len(jf.by_user)
        for jb, tb in zip(jf.by_user, f.by_user):
            assert jb.row_ids.shape[0] % s == 0
            for name in ("row_ids", "col_ids", "length"):
                np.testing.assert_array_equal(
                    getattr(tb, name).numpy(), _shards(getattr(jb, name))[r])
        for name in ("excl", "gt", "gt_len", "hist_size"):
            np.testing.assert_array_equal(getattr(f, name).numpy(),
                                          _shards(getattr(jf, name))[r])


def test_sharded_contiguous_buckets_read_their_own_rows(tiny):
    # a contiguous bucket's block is a contiguous window of the table:
    # the slice read_rows takes is the rows its row_ids name
    ds, _ = tiny
    table = torch.arange(ds.num_users * 3, dtype=torch.float32).reshape(
        ds.num_users, 3)
    for r in range(4):
        dd = DeviceData.build(_port(ds), device="cpu", mesh=_mesh(4, r))
        contiguous = [b for b in dd.by_user if b.contiguous]
        assert contiguous
        for b in contiguous:
            real = b.length > 0
            np.testing.assert_array_equal(
                assemble.read_rows(table, b)[real].numpy(),
                table[b.row_ids[real]].numpy())


def test_traffic_counts_calls_and_bytes():
    t = audit.Traffic()
    assert t.snapshot() == {} and audit.total_bytes(t.snapshot()) == 0
    t.record("all-gather", 100)
    t.record("all-gather", 28)
    t.record("all-reduce", 8)
    t.record("barrier", 0)
    snap = t.snapshot()
    assert snap == {"all-gather": (2, 128), "all-reduce": (1, 8),
                    "barrier": (1, 0)}
    assert audit.total_bytes(snap) == 136
    assert audit.total_calls(snap) == 4
    t.reset()
    assert t.snapshot() == {}


def test_collectives_record_the_jax_byte_convention(monkeypatch):
    # per-device result-shape bytes: an all-gather counts the gathered
    # array, an all-reduce and a broadcast their shape once
    import torch.distributed as dist

    def all_gather(parts, x, group=None):
        for p in parts:
            p.copy_(x)

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "all_reduce", lambda x, group=None: None)
    monkeypatch.setattr(dist, "broadcast", lambda x, src, group=None: None)
    monkeypatch.setattr(dist, "barrier", lambda group=None: None)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    m = _mesh(4, 1)
    x = torch.ones((5, 3), dtype=torch.float32)
    assert mesh_lib.all_gather_rows(m, x).shape == (20, 3)
    mesh_lib.all_reduce_sum(m, torch.ones(7, dtype=torch.float64))
    mesh_lib.broadcast(m, torch.ones(2, dtype=torch.int64))
    mesh_lib.barrier(m)
    assert m.traffic.snapshot() == {
        "all-gather": (1, 4 * 5 * 3 * 4), "all-reduce": (1, 7 * 8),
        "broadcast": (1, 2 * 8), "barrier": (1, 0)}


@pytest.mark.parametrize("s,n_pad,chunk", [
    (1, 1024, 1024), (2, 1024, 1024), (8, 1024, 300), (2, 96, 1024),
    (8, 2048, 1000), (4, 48, 20), (2, 1024, 7)])
def test_eval_chunk_under_shards_matches_jax(s, n_pad, chunk):
    cfg = Config(dim=8, eval_chunk=chunk)
    jax_mesh = None if s == 1 else _jax_mesh(s)

    class JaxModel:        # the fields JAX's _eval_chunk reads
        mesh = jax_mesh

    JaxModel.cfg = jx.Config(dim=8, eval_chunk=chunk)
    want = JaxRecommender._eval_chunk(JaxModel(), n_pad)
    m = get_model("safer2", cfg, 10, 10, device="cpu",
                  mesh=None if s == 1 else _mesh(s, s - 1))
    got = m._eval_chunk(n_pad)
    assert got == want
    assert got % s == 0 and n_pad % got == 0
    assert m._rank_chunk(n_pad // s) * s == got


def test_row_range_and_place():
    assert mesh_lib.row_range(None, 48) == (0, 48)
    assert mesh_lib.row_range(_mesh(4, 2), 48) == (24, 36)
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.row_range(_mesh(4, 0), 30)
    assert mesh_lib.place("cpu", _mesh(2, 1)) == CPU
    with pytest.raises(ValueError, match="differs from the mesh"):
        mesh_lib.place("cuda", _mesh(2, 1))
    with pytest.raises(ValueError, match="outside a world"):
        _mesh(2, 2)
    assert mesh_lib.num_shards(None) == 1
    assert mesh_lib.num_shards(_mesh(8, 3)) == 8


def test_model_refuses_data_of_another_mesh(tiny):
    ds, _ = tiny
    m = get_model("safer2", Config(dim=8), ds.num_users, ds.num_items,
                  device="cpu", mesh=_mesh(2, 0))
    with pytest.raises(ValueError, match="built for mesh"):
        m.initialize(DeviceData.build(_port(ds), device="cpu"))
    with pytest.raises(ValueError, match="built for mesh"):
        m.initialize(DeviceData.build(_port(ds), device="cpu",
                                      mesh=_mesh(2, 1)))


@pytest.mark.parametrize("s", [1, 2, 8])
def test_server_rungs_split_over_the_shards(s):
    m = get_model("safer2", Config(dim=8), 20, 20, device="cpu",
                  mesh=None if s == 1 else _mesh(s, 0))
    srv = Server(m, k=5, batch_sizes=(1, 64, 100, 512))
    assert all(b % (8 * s) == 0 for b in srv.batch_sizes)
    assert srv.batch_sizes[0] == 8 * s
    assert srv._rung(srv.batch_sizes, 5000) % (8 * s) == 0


def test_cli_refuses_a_mesh_above_the_device_count(monkeypatch, capsys):
    # JAX's message (cli.py:202-205), the device count patched: this box
    # has no card
    from safer2_recommender_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        cli.run(["--model_name", "safer2", "--train_data", __file__,
                 "--test_train_data", __file__, "--test_test_data", __file__,
                 "--mesh", "2"])
    assert str(exc.value) == "--mesh 2 exceeds the 1 available devices"


def test_logger_prefix_names_the_rank():
    from safer2_recommender_tpu_torch.utils import logging as ulog

    log = ulog.get_logger()
    before = list(log.handlers)
    try:
        ulog.setup(mesh=_mesh(2, 1))
        handler = next(h for h in log.handlers if h.name == ulog._HANDLER)
        rec = logging.LogRecord(log.name, logging.INFO, __file__, 1,
                                "distributed: process %d/%d", (1, 2), None)
        assert handler.format(rec).endswith(
            "safer2_recommender_tpu_torch rank 1/2] distributed: process 1/2")
        ulog.setup()
        rec = logging.LogRecord(log.name, logging.INFO, __file__, 1, "x", (),
                                None)
        assert handler.format(rec).endswith("safer2_recommender_tpu_torch] x")
    finally:
        # leave no handler bound to this test's stderr for later tests
        for h in log.handlers[:]:
            if h not in before:
                log.removeHandler(h)
        if before:
            ulog.setup()


def test_sharded_buckets_take_the_whole_buckets_routes(monkeypatch):
    # the shape-driven choices (the wide streamed assembly, the solve
    # batches that decide the rotated basis) read the whole bucket, as
    # the JAX package's global arrays do: a rank's block takes the route
    # of the bucket a one-process build with the mesh's row multiple
    # gives (a fault found on the card: deciding on the block's rows
    # split the one-process run's solve batches differently)
    from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
    from safer2_recommender_tpu_torch.models import common

    monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1 << 20)
    ds = Dataset(*powerlaw_dataset(3000, 1500, seed=0))
    dim, s = 128, 2
    whole = DeviceData.build(ds, device="cpu", dim=dim, row_multiple=8 * s)
    for r in range(s):
        part = DeviceData.build(ds, device="cpu", dim=dim, mesh=_mesh(s, r))
        for side in ("by_user", "by_item"):
            wb, pb = getattr(whole, side), getattr(part, side)
            assert [b.global_rows for b in pb] == [b.n_rows for b in wb]
            wide = [assemble.is_wide(b, dim) for b in wb]
            assert [assemble.is_wide(b, dim) for b in pb] == wide
            for budget in (1 << 22, 1 << 24, 1 << 26):
                assert common._solve_groups(pb, dim, budget) == \
                    common._solve_groups(wb, dim, budget)
    assert any(assemble.is_wide(b, dim) for b in whole.by_item)
