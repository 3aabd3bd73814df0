"""The port's multi-device path in real processes: two ranks spawned by
``parallel.spawn`` over gloo on the CPU, against the single-process port
and the JAX package's own 2-device mesh (the 8-device CPU mesh of
tests/conftest.py, cut to two devices). The cases, their bounds and the
one spawn that runs them all are in tests/torch_mesh_cases.py, shared
with the 8-rank module tests/test_torch_mesh8.py."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from safer2_recommender_tpu_torch import (CheckpointManager, Config,
                                          get_model, parallel)
from safer2_recommender_tpu_torch.parallel import audit
from torch_mesh_cases import (EPOCH_BUDGETS, EPOCH_KEYS, LAUNCH_KEYS,
                              METRIC_ATOL, METRIC_RTOL, SPAWN_TIMEOUT_S,
                              STATE_FIELDS, close, ds_of,
                              epoch_collective_bytes_bounded,
                              eval_collective_bytes_bounded,
                              launches_are_the_layouts, overlap, ranks_equal,
                              run_all, solve_inputs, tiny_pairs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_fails(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    parallel.mesh.barrier(mesh)     # rank 0 waits in a collective


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    return run_all(tiny, str(tmp_path_factory.mktemp("mesh_ckpt")), 2)


# --------------------------------------------------------------------------
# Epochs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", EPOCH_KEYS)
def test_two_rank_epoch_matches_one_process_and_the_jax_mesh(runs, key):
    got = runs["ranks"][0][key]["state"]
    for want in (runs["single"][key]["state"], runs["jax"][key][0]):
        close(got["user_emb"], want["user_emb"])
        close(got["user_loss"], want["user_loss"])
        close(got["item_emb"], want["item_emb"])
    ranks_equal(runs, key)
    # the first epoch's dual weights agree too
    close(got["dual_weight"], runs["jax"][key][0]["dual_weight"])


@pytest.mark.parametrize("key", LAUNCH_KEYS)
def test_two_rank_solves_take_the_one_process_launches(runs, key):
    # each rank's launches are 1/2 of one process's on the mesh's bucket
    # layout (rows padded to a multiple of 16)
    launches_are_the_layouts(runs, key, 2)


@pytest.mark.parametrize("name", ["safer2pp", "ialspp"])
def test_two_rank_interleaved_epoch_matches_one_process(runs, name):
    key = f"{name}_interleaved"
    got = runs["ranks"][0][key]["state"]
    want = runs["single"][key]["state"]
    for f in ("user_emb", "item_emb", "user_loss"):
        close(got[f], want[f])
    ranks_equal(runs, key)
    # one collective per side step and one for the losses
    calls = audit.total_calls(runs["ranks"][0][key]["epoch_traffic"])
    assert calls == 2 * (8 // 4) + 1


def test_two_rank_evaluation_matches_one_process_and_the_jax_mesh(runs):
    got = runs["ranks"][0]["eval"]
    jax_ndcg, jax_recall = runs["jax"]["eval"][1]
    for ndcg, recall in ((runs["single"]["eval"]["ndcg"],
                          runs["single"]["eval"]["recall"]),
                         (jax_ndcg, jax_recall)):
        close(got["ndcg"], ndcg, METRIC_RTOL, METRIC_ATOL)
        close(got["recall"], recall, METRIC_RTOL, METRIC_ATOL)
    np.testing.assert_array_equal(got["ndcg"], runs["ranks"][1]["eval"]["ndcg"])


# --------------------------------------------------------------------------
# Collective budgets
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(EPOCH_BUDGETS))
def test_epoch_collective_bytes_bounded(runs, tiny, name):
    epoch_collective_bytes_bounded(runs, tiny, name)


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_eval_collective_bytes_bounded(runs, name):
    eval_collective_bytes_bounded(runs, name)


def test_sharded_spd_solve_issues_no_collective(runs):
    # the counterpart of test_pallas_leaf_partitions_over_batch: each rank
    # solves its block of the batch alone
    a, b = solve_inputs()
    ref = np.stack([np.linalg.solve(a[i], b[i]) for i in range(a.shape[0])])
    got = [r["spd_solve"] for r in runs["ranks"]]
    assert all(g["traffic"] == {} for g in got)
    np.testing.assert_allclose(np.concatenate([g["x"] for g in got]), ref,
                               rtol=2e-3, atol=2e-4)


# --------------------------------------------------------------------------
# Serving and checkpoints
# --------------------------------------------------------------------------


def test_server_on_mesh(runs):
    # test_serving.py::test_server_on_mesh: the same users, ids within
    # 0.9 overlap of the one-process server; every rank serves the batch
    mu, mids = runs["ranks"][0]["eval"]["served"]
    su, sids = runs["single"]["eval"]["served"]
    np.testing.assert_array_equal(mu, su)
    assert overlap(mids, sids) > 0.9
    u1, ids1 = runs["ranks"][1]["eval"]["served"]
    np.testing.assert_array_equal(mu, u1)
    np.testing.assert_array_equal(mids, ids1)
    # recommend() on the mesh: every rank returns every user
    ru, rids = runs["ranks"][0]["eval"]["recommended"]
    np.testing.assert_array_equal(ru, mu)
    assert overlap(rids, mids) > 0.9
    np.testing.assert_array_equal(
        rids, runs["ranks"][1]["eval"]["recommended"][1])


def test_checkpoint_written_on_mesh_restores_in_one_process(runs):
    case = runs["cases"]["eval"]
    ds = ds_of(case["pairs"])
    fresh = get_model("safer2", Config(**case["cfg"]), ds.num_users,
                      ds.num_items, device="cpu")
    state, epoch, meta = CheckpointManager(runs["ckpt"]).restore_with_meta(
        fresh.state, generator=fresh.generator)
    assert epoch == 1 and state is not None
    fresh.state = state
    fresh.load_checkpoint_meta(meta)
    got = fresh.export_state()
    want = runs["ranks"][0]["eval"]["state"]
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(got[f], want[f])


# --------------------------------------------------------------------------
# Spawn and the CLI
# --------------------------------------------------------------------------


def test_spawn_raises_a_failed_rank_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed") as exc:
        parallel.spawn(rank_fails, 2, device="cpu", timeout_s=120)
    assert "rank 1 fails on purpose" in str(exc.value)


def _write_csvs(tmp_path, pairs):
    def write(path, arr):
        np.savetxt(path, arr, fmt="%d", delimiter=",", header="uid,sid",
                   comments="")

    rng = np.random.default_rng(3)
    write(tmp_path / "train.csv", pairs)
    held = pairs[rng.permutation(len(pairs))[:600]]
    write(tmp_path / "tr.csv", held[:400])
    write(tmp_path / "te.csv", held[400:])
    return ["--model_name", "safer2", "--dim", "8", "--epoch", "2",
            "--bandwidth", "0.3", "--print_evaluation_stats", "1",
            "--device", "cpu",
            "--train_data", str(tmp_path / "train.csv"),
            "--test_train_data", str(tmp_path / "tr.csv"),
            "--test_test_data", str(tmp_path / "te.csv")]


def _cli(argv, env=None):
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "safer2_recommender_tpu_torch.cli", *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(procs, timeout=SPAWN_TIMEOUT_S):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return [err for _, err in outs]


def _check_lines(err, rank, world):
    prefix = (rf"^I\d{{4}} \d\d:\d\d:\d\d safer2_recommender_tpu_torch "
              rf"rank {rank}/{world}\] ")
    for pattern in (r"Epoch: 1, Timer: Train=\d+$", r"Validation Results$",
                    r"Xi:[\d.e-]+$",
                    r"Mean NDCG@5=\d\.\d{4} .* Mean NDCG@100=\d\.\d{4}$"):
        assert re.search(prefix + pattern, err, re.M), (rank, pattern)


def test_cli_mesh_2_on_the_cpu(tiny, tmp_path):
    # replaces the refused-flag case of --mesh (test_torch_cli.py): two
    # spawned gloo ranks train and evaluate, every rank logs the JAX lines
    argv = _write_csvs(tmp_path, tiny_pairs(tiny)) + ["--mesh", "2"]
    (err,) = _finish([_cli(argv)])
    for rank in (0, 1):
        _check_lines(err, rank, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_distributed_two_processes(tiny, tmp_path):
    # replaces the refused-flag case of --distributed (test_torch_cli.py;
    # counterpart of test_distributed.py:84-105): two processes with
    # torchrun's environment join one gloo group and exit 0
    argv = _write_csvs(tmp_path, tiny_pairs(tiny)) + ["--distributed", "1"]
    port = str(_free_port())
    procs = [_cli(argv, dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=port)) for r in range(2)]
    errs = _finish(procs)
    for rank, err in enumerate(errs):
        assert f"distributed: process {rank}/2, 2 global devices" in err
        _check_lines(err, rank, 2)
