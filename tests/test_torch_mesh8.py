"""The port's multi-device path at world size 8: eight ranks spawned by
``parallel.spawn`` over gloo on the CPU, against one port process and
the JAX package's mesh of all 8 CPU devices that tests/conftest.py
forces (``get_mesh()``, as tests/test_multidevice.py runs it).

At S = 8 the sharding differs from S = 2 in what each rank holds: the
row multiple of every bucket is 8 x 8, the evaluation chunk and the
Server's rungs are multiples of 8, and a small bucket leaves some ranks
a block that is all padding. The cases, their bounds (the 2-rank
module's, unchanged) and the one spawn that runs them are in
tests/torch_mesh_cases.py; ``dryrun_multichip(8, "cpu")`` runs too."""

import jax
import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.models import common as jcommon
from safer2_recommender_tpu.ops import assemble as jassemble
from safer2_recommender_tpu.parallel import get_mesh as jax_get_mesh
from safer2_recommender_tpu_torch import Dataset, DeviceData
from safer2_recommender_tpu_torch.dryrun import dryrun_multichip
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import assemble
from safer2_recommender_tpu_torch.parallel import Mesh, audit
from torch_mesh_cases import (EPOCH_BUDGETS, EPOCH_KEYS, LAUNCH_KEYS,
                              METRIC_ATOL, METRIC_RTOL, STATE_FIELDS, close,
                              epoch_collective_bytes_bounded,
                              eval_collective_bytes_bounded,
                              launches_are_the_layouts, ranks_equal, run_all,
                              solve_inputs)

S = 8


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    return run_all(tiny, str(tmp_path_factory.mktemp("mesh8_ckpt")), S)


def test_every_rank_ran_in_a_world_of_eight(runs):
    assert [r["world_size"] for r in runs["ranks"]] == [S] * S


@pytest.mark.parametrize("key", EPOCH_KEYS)
def test_eight_rank_epoch_matches_one_process_and_the_jax_mesh(runs, key):
    got = runs["ranks"][0][key]["state"]
    for want in (runs["single"][key]["state"], runs["jax"][key][0]):
        for f in STATE_FIELDS:
            close(got[f], want[f])
        close(got["xi"], want["xi"])
    ranks_equal(runs, key)


@pytest.mark.parametrize("key", LAUNCH_KEYS)
def test_eight_rank_solves_take_the_one_process_launches(runs, key):
    # each rank's launches are 1/8 of one process's on the mesh's bucket
    # layout (rows padded to a multiple of 64); at this size the default
    # layout's have the same count and r
    want = launches_are_the_layouts(runs, key, S)
    one = runs["single"][key]["chol_shapes"]
    assert [sh[1:] for sh in one] == [sh[1:] for sh in want]


@pytest.mark.parametrize("name", ["safer2pp", "ialspp"])
def test_eight_rank_interleaved_epoch_matches_one_process(runs, name):
    key = f"{name}_interleaved"
    got = runs["ranks"][0][key]["state"]
    want = runs["single"][key]["state"]
    for f in STATE_FIELDS:
        close(got[f], want[f])
    ranks_equal(runs, key)
    # one collective per side step and one for the losses
    calls = audit.total_calls(runs["ranks"][0][key]["epoch_traffic"])
    assert calls == 2 * (8 // 4) + 1


def test_eight_rank_layout_decides_wide_buckets_and_batches_as_jax(
        tiny, monkeypatch):
    # At S = 8 every bucket pads to a multiple of 64 rows, so a bucket's
    # whole shape can cross the wide-slab limit, and a batch the memory
    # budget, where the one-process layout's does not: the solve batches,
    # and so the kernel's launches, follow the mesh's layout. The JAX
    # package decides from the same global shape; a limit set between
    # the two layouts' rows shows both.
    assert jax.device_count() >= S
    ds, _ = tiny
    dim = 8
    port_ds = Dataset(ds.user_ids, ds.item_ids)
    one = DeviceData.build(port_ds, device="cpu")
    rank = DeviceData.build(port_ds, device="cpu",
                            mesh=Mesh(world_size=S, rank=0,
                                      device=torch.device("cpu")))
    jdd = jx.DeviceData.build(ds, mesh=jax_get_mesh(jax.devices()[:S]))
    b1, b8 = one.by_item, rank.by_item
    assert [b.width for b in b1] == [b.width for b in b8]
    i = next(k for k, (x, y) in enumerate(zip(b1, b8))
             if x.width > dim and y.global_rows > x.global_rows)
    limit = b1[i].global_rows * b1[i].width * (dim + 1) * 4
    monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", limit)
    monkeypatch.setattr(jassemble, "WIDE_SLAB_BYTES", limit)
    assert not assemble.is_wide(b1[i], dim) and assemble.is_wide(b8[i], dim)
    assert [assemble.is_wide(b, dim) for b in b8] == [
        jassemble.is_wide(b, dim) for b in jdd.by_item]
    # a budget the one-process layout's buckets fill exactly
    # (common._solve_groups' cost), which the padded ones overflow
    budget = sum(b.global_rows * (dim * dim * 4 + (dim + 1) * 4 * (
        min(b.width, assemble.WIDE_CHUNK) if assemble.is_wide(b, dim)
        else b.width)) for b in b1)
    assert budget > 64 * dim * dim * 4
    assert common._solve_groups(b1, dim, budget) == [list(range(len(b1)))]
    groups = common._solve_groups(b8, dim, budget)
    jgroups = jcommon._solve_groups(list(jdd.by_item), dim, budget)
    ids = {id(b): k for k, b in enumerate(jdd.by_item)}
    assert groups == [[ids[id(b)] for b in g] for g in jgroups]
    assert groups != common._solve_groups(b1, dim, budget)


def test_eight_rank_evaluation_matches_one_process_and_the_jax_mesh(runs):
    got = runs["ranks"][0]["eval"]
    jax_ndcg, jax_recall = runs["jax"]["eval"][1]
    for ndcg, recall in ((runs["single"]["eval"]["ndcg"],
                          runs["single"]["eval"]["recall"]),
                         (jax_ndcg, jax_recall)):
        close(got["ndcg"], ndcg, METRIC_RTOL, METRIC_ATOL)
        close(got["recall"], recall, METRIC_RTOL, METRIC_ATOL)
    for r in runs["ranks"][1:]:
        np.testing.assert_array_equal(r["eval"]["ndcg"], got["ndcg"])
        np.testing.assert_array_equal(r["eval"]["recall"], got["recall"])


def test_buckets_split_over_eight_and_some_rank_holds_only_padding(runs):
    # test_multidevice.py::test_sharded_bucket_row_counts_divisible; the
    # epochs above ran with the all-padding blocks this finds
    blocks = [r["blocks"] for r in runs["ranks"]]
    padded = [rows for rows, _ in blocks[0]]
    assert all(rows % S == 0 for rows in padded)
    for b in blocks[1:]:
        assert [rows for rows, _ in b] == padded
    live = np.array([[n for _, n in b] for b in blocks])   # [rank, bucket]
    empty = np.argwhere(live == 0)
    assert empty.size, "no rank was left a block of padding only"
    # every bucket still has its live rows somewhere
    assert (live.sum(axis=0) > 0).all()


@pytest.mark.parametrize("name", sorted(EPOCH_BUDGETS))
def test_eight_rank_epoch_collective_bytes_bounded(runs, tiny, name):
    epoch_collective_bytes_bounded(runs, tiny, name)


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_eight_rank_eval_collective_bytes_bounded(runs, name):
    eval_collective_bytes_bounded(runs, name)


def test_eight_rank_spd_solve_issues_no_collective(runs):
    a, b = solve_inputs()
    ref = np.stack([np.linalg.solve(a[i], b[i]) for i in range(a.shape[0])])
    got = [r["spd_solve"] for r in runs["ranks"]]
    assert all(g["traffic"] == {} for g in got)
    np.testing.assert_allclose(np.concatenate([g["x"] for g in got]), ref,
                               rtol=2e-3, atol=2e-4)


def test_eight_rank_server_equals_recommend_and_every_rank(runs):
    # the Server's ids are recommend()'s but for rows whose lists differ
    # by near-tie swaps only (probes/serving_scale.py::TIE_TOL), on every
    # rank, and every rank serves the same users and ids
    r0 = runs["ranks"][0]["eval"]
    users, ids = r0["served"]
    np.testing.assert_array_equal(users, r0["recommended"][0])
    assert users.size == 30
    for r in runs["ranks"]:
        rows, ties = r["eval"]["tie_rows"]
        np.testing.assert_array_equal(rows, ties)
        np.testing.assert_array_equal(r["eval"]["served"][0], users)
        np.testing.assert_array_equal(r["eval"]["served"][1], ids)
        np.testing.assert_array_equal(r["eval"]["recommended"][1],
                                      r0["recommended"][1])


def test_dryrun_multichip_on_eight_ranks():
    ranks = dryrun_multichip(S, "cpu")
    assert [r["rank"] for r in ranks] == list(range(S))
    assert all(r["world_size"] == S for r in ranks)
    runs = ranks[0]["runs"]
    assert set(runs) == {"safer2pp", "safer2pp+inter", "safer2", "ials",
                         "ialspp", "erm_mf", "cvar_mf"}
    for r in ranks[1:]:
        assert r["runs"] == runs
