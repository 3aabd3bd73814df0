"""The port's multi-device path in real processes: two ranks spawned by
``parallel.spawn`` over gloo on the CPU, against the single-process port
and the JAX package's own 2-device mesh (the 8-device CPU mesh of
tests/conftest.py, cut to two devices).

The JAX side draws the initial tables; ``interop.state_from_jax``
carries them into every port run, so the three epochs start equal. The
bounds are the JAX package's own for its sharded-vs-single tests
(tests/test_multidevice.py): rtol 5e-3, atol 5e-5 on tables and losses,
rtol 5e-3, atol 5e-4 on metrics, and its collective-byte budgets.

Every 2-rank run of the module happens in ONE spawn (a module fixture),
while the parent computes the JAX side: a spawn, not an epoch, is what
costs here. Rendezvous is a file store in a temporary directory, so
parallel test workers never collide on a port; each rank runs one
intra-op thread."""

import os
import re
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from safer2_recommender_tpu_torch import (CheckpointManager, Config,
                                          Dataset, DeviceData, FoldInData,
                                          Server, get_model, interop,
                                          parallel)
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.parallel import audit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("ials", "ialspp", "erm_mf", "cvar_mf", "safer2", "safer2pp")
RTOL, ATOL = 5e-3, 5e-5
METRIC_RTOL, METRIC_ATOL = 5e-3, 5e-4
SPAWN_TIMEOUT_S = 600
SLACK = 256 * 1024     # Gramian-size and scalar traffic at tiny scale
# test_multidevice.py:139-173
EPOCH_BUDGETS = {"safer2": 3.0, "safer2pp": 2.5, "ials": 3.0}
AUDIT_CFG = dict(dim=16, block_size=8, compute_dtype="f32")
EVAL_CFG = dict(dim=8, bandwidth=0.3)


def _tiny_pairs(tiny) -> np.ndarray:
    ds, _ = tiny
    return np.stack([ds.user_ids, ds.item_ids], 1)


def _rotated_pairs() -> np.ndarray:
    # test_multidevice.py:228-256: one user wider than dim / 2 takes the
    # eigenbasis-rotated direct path
    rng = np.random.default_rng(7)
    hot = np.stack([np.zeros(150, np.int64), np.arange(150)], 1)
    tail = np.stack([rng.integers(1, 120, 2000),
                     rng.integers(0, 150, 2000)], 1)
    return np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)


def _request(pairs, n_users, seed, hist=6):
    """test_serving.py::_request on the pairs' id universe."""
    rng = np.random.default_rng(seed)
    users = rng.choice(int(pairs[:, 0].max()) + 1, size=n_users,
                       replace=False)
    u = np.repeat(users, hist).astype(np.int32)
    i = rng.integers(0, int(pairs[:, 1].max()) + 1, u.size).astype(np.int32)
    return np.stack([u, i], 1)


def _overlap(a, b) -> float:
    return np.mean([np.intersect1d(x, y).size / x.size
                    for x, y in zip(a, b)])


# --------------------------------------------------------------------------
# One run of a case: the same code in each rank and in the parent
# --------------------------------------------------------------------------


def _ds(pairs) -> Dataset:
    return Dataset(pairs[:, 0], pairs[:, 1])


def _traffic(mesh):
    return {} if mesh is None else mesh.traffic.snapshot()


def _reset(mesh):
    if mesh is not None:
        mesh.traffic.reset()


def run_case(mesh, case: dict) -> dict:
    """Build, carry (or initialize), train one epoch and, as the case
    asks, evaluate, serve and checkpoint; on ``mesh`` or in one process
    (None). Returns numpy results in original id space."""
    ds = _ds(case["pairs"])
    dim = case.get("build_dim", 0)
    dd = DeviceData.build(ds, device="cpu", dim=dim, mesh=mesh)
    m = get_model(case["model"], Config(**case["cfg"]), ds.num_users,
                  ds.num_items, device="cpu", mesh=mesh)
    if case.get("init") is not None:
        interop.state_from_jax(case["init"], m, dd, steps=0)
    else:
        m.initialize(dd)
    _reset(mesh)
    m.train_epoch(dd)
    out = {"state": m.export_state(dd), "epoch_traffic": _traffic(mesh)}
    if "eval" in case:
        tr, te = (_ds(p) for p in case["eval"])
        fold = FoldInData.build(tr, te, num_items=ds.num_items, device="cpu",
                                dim=dim, mesh=mesh)
        _reset(mesh)
        m._fold_in(m.state, m._permute_fold(fold))
        out["fold_in_traffic"] = _traffic(mesh)
        _reset(mesh)
        res = m.evaluate_dataset(fold)
        out["eval_traffic"] = _traffic(mesh)
        out["ndcg"], out["recall"] = res.mean_ndcg(), res.mean_recall()
        out["fold"] = dict(n_pad=fold.n_pad, hmax=fold.excl.shape[1],
                           gmax=fold.gt.shape[1])
    if "serve" in case:
        out["served"] = Server(m, k=10).recommend(_ds(case["serve"]))
        out["recommended"] = m.recommend(_ds(case["serve"]), k=10)
    if "ckpt" in case:
        CheckpointManager(case["ckpt"], mesh=mesh).save(
            m.state, 1, meta=m.checkpoint_meta(), generator=m.generator)
    return out


def _solve_block(mesh) -> dict:
    """The rank's rows of one batch of SPD systems through spd_solve."""
    rng = np.random.default_rng(0)
    n, d = 256, 32
    x = rng.normal(size=(n, d + 3, d)).astype(np.float32)
    a = np.einsum("nld,nle->nde", x, x) + 2.0 * np.eye(d, dtype=np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    lo, hi = parallel.mesh.row_range(mesh, n)
    _reset(mesh)
    got = block_chol.spd_solve(torch.from_numpy(a[lo:hi]),
                               torch.from_numpy(b[lo:hi]))
    return {"x": got.numpy(), "traffic": _traffic(mesh)}


def rank_main(mesh, cases: dict) -> dict:
    """Every case of the module on one rank of the mesh."""
    torch.set_num_threads(1)
    out = {key: run_case(mesh, case) for key, case in cases.items()}
    out["spd_solve"] = _solve_block(mesh)
    return out


def rank_fails(mesh) -> None:
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    parallel.mesh.barrier(mesh)     # rank 0 waits in a collective


# --------------------------------------------------------------------------
# The JAX side and the module's runs
# --------------------------------------------------------------------------


def _jax_init(jx, jmesh, pairs, model, cfg, build_dim):
    """A JAX model initialized on the 2-device mesh, its DeviceData and
    its initial state (numpy, original id space)."""
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    jdd = jx.DeviceData.build(jds, mesh=jmesh, dim=build_dim)
    m = jx.get_model(model, jx.Config(**cfg), jds.num_users, jds.num_items,
                     mesh=jmesh)
    m.initialize(jdd)
    return m, jdd, m.export_state(jdd)


def _jax_epoch(jx, jmesh, m, jdd, build_dim, eval_pairs):
    """One JAX mesh epoch from the initialized model: (state after it,
    metrics or None)."""
    m.train_epoch(jdd)
    metrics = None
    if eval_pairs is not None:
        tr, te = (jx.Dataset(p[:, 0], p[:, 1]) for p in eval_pairs)
        fold = jx.FoldInData.build(tr, te, num_items=jdd.num_items,
                                   dim=build_dim, mesh=jmesh)
        r = m.evaluate_dataset(fold)
        metrics = (r.mean_ndcg(), r.mean_recall())
    return m.export_state(jdd), metrics


@pytest.fixture(scope="module")
def runs(tiny, tmp_path_factory):
    import jax

    import safer2_recommender_tpu as jx
    from safer2_recommender_tpu.parallel import get_mesh

    if jax.device_count() < 2:
        pytest.skip("needs >= 2 JAX devices")
    jmesh = get_mesh(jax.devices()[:2])
    pairs = _tiny_pairs(tiny)
    eval_pairs = (pairs[::2], pairs[1::2])
    plan = {name: (pairs, name, dict(dim=8, block_size=4), 0, None)
            for name in MODELS}
    plan["woodbury"] = (pairs, "safer2", dict(dim=128), 128, None)
    plan["rotated"] = (_rotated_pairs(), "safer2", dict(dim=128), 128, None)
    plan["eval"] = (pairs, "safer2", EVAL_CFG, 0, eval_pairs)

    # the JAX initial tables first (cheap), then the ranks run while the
    # JAX epochs compile and run here
    jax_models = {key: _jax_init(jx, jmesh, p, model, cfg, dim)
                  for key, (p, model, cfg, dim, _) in plan.items()}
    inits = {key: v[2] for key, v in jax_models.items()}
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    cases = {key: dict(pairs=p, model=model, cfg=cfg, build_dim=dim,
                       init=inits[key])
             for key, (p, model, cfg, dim, _) in plan.items()}
    cases["eval"].update(eval=eval_pairs, serve=_request(pairs, 30, seed=8),
                         ckpt=ckpt)
    for name in ("safer2pp", "ialspp"):
        cases[f"{name}_interleaved"] = dict(
            pairs=pairs, model=name, init=inits[name],
            cfg=dict(dim=8, block_size=4, block_interleaved=True))
    for name in EPOCH_BUDGETS:
        cases[f"audit_{name}"] = dict(pairs=pairs, model=name,
                                      cfg=AUDIT_CFG)
    cases["audit_eval_safer2pp"] = dict(
        pairs=pairs, model="safer2pp", cfg=AUDIT_CFG, build_dim=16,
        eval=eval_pairs)
    cases["audit_eval_safer2"] = dict(
        pairs=pairs, model="safer2", cfg=AUDIT_CFG, build_dim=16,
        eval=eval_pairs)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as ex:
            ranks = ex.submit(parallel.spawn, rank_main, 2, device="cpu",
                              args=(cases,), timeout_s=SPAWN_TIMEOUT_S)
            jax_runs = {key: _jax_epoch(jx, jmesh, *jax_models[key][:2],
                                        plan[key][3], plan[key][4])
                        for key in plan}
            single = {key: run_case(None, {k: v for k, v in case.items()
                                           if k != "ckpt"})
                      for key, case in cases.items()
                      if not key.startswith("audit")}
            ranks = ranks.result()
    finally:
        torch.set_num_threads(threads)
    return dict(cases=cases, jax=jax_runs, single=single, ranks=ranks,
                ckpt=ckpt)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _ranks_equal(runs, key):
    r0, r1 = (r[key]["state"] for r in runs["ranks"])
    for f in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(r0[f], r1[f])
    assert r0["xi"] == r1["xi"]


# --------------------------------------------------------------------------
# Epochs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", MODELS + ("woodbury", "rotated"))
def test_two_rank_epoch_matches_one_process_and_the_jax_mesh(runs, key):
    got = runs["ranks"][0][key]["state"]
    for want in (runs["single"][key]["state"], runs["jax"][key][0]):
        _close(got["user_emb"], want["user_emb"])
        _close(got["user_loss"], want["user_loss"])
        _close(got["item_emb"], want["item_emb"])
    _ranks_equal(runs, key)
    # the first epoch's dual weights agree too
    _close(got["dual_weight"], runs["jax"][key][0]["dual_weight"])


@pytest.mark.parametrize("name", ["safer2pp", "ialspp"])
def test_two_rank_interleaved_epoch_matches_one_process(runs, name):
    key = f"{name}_interleaved"
    got = runs["ranks"][0][key]["state"]
    want = runs["single"][key]["state"]
    for f in ("user_emb", "item_emb", "user_loss"):
        _close(got[f], want[f])
    _ranks_equal(runs, key)
    # one collective per side step and one for the losses
    calls = audit.total_calls(runs["ranks"][0][key]["epoch_traffic"])
    assert calls == 2 * (8 // 4) + 1


def test_two_rank_evaluation_matches_one_process_and_the_jax_mesh(runs):
    got = runs["ranks"][0]["eval"]
    jax_ndcg, jax_recall = runs["jax"]["eval"][1]
    for ndcg, recall in ((runs["single"]["eval"]["ndcg"],
                          runs["single"]["eval"]["recall"]),
                         (jax_ndcg, jax_recall)):
        _close(got["ndcg"], ndcg, METRIC_RTOL, METRIC_ATOL)
        _close(got["recall"], recall, METRIC_RTOL, METRIC_ATOL)
    np.testing.assert_array_equal(got["ndcg"], runs["ranks"][1]["eval"]["ndcg"])


# --------------------------------------------------------------------------
# Collective budgets
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(EPOCH_BUDGETS))
def test_epoch_collective_bytes_bounded(runs, tiny, name):
    ds, _ = tiny
    traffic = runs["ranks"][0][f"audit_{name}"]["epoch_traffic"]
    assert traffic, f"{name}: a sharded epoch issued no collective"
    table_bytes = (ds.num_users + ds.num_items) * AUDIT_CFG["dim"] * 4
    total = audit.total_bytes(traffic)
    assert total <= EPOCH_BUDGETS[name] * table_bytes + SLACK, (
        f"{name}: {total} collective bytes vs {table_bytes} table bytes: "
        f"{traffic}")
    # one all-gather per sweep and one for the losses
    assert traffic == {"all-gather": (3, traffic["all-gather"][1])}


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_eval_collective_bytes_bounded(runs, name):
    got = runs["ranks"][0][f"audit_eval_{name}"]
    tf, te = got["fold_in_traffic"], got["eval_traffic"]
    assert tf and te, f"{name}: fold-in or eval issued no collective"
    dim = AUDIT_CFG["dim"]
    f = got["fold"]
    ue_bytes = f["n_pad"] * dim * 4
    # the JAX package's int32 excl, gt and gt_len rows, plus ue
    input_bytes = f["n_pad"] * (f["hmax"] + f["gmax"] + 1) * 4 + ue_bytes
    sweeps = Config().eval_fold_in_epochs if name == "safer2pp" else 1
    fold_in = audit.total_bytes(tf)
    scoring = audit.total_bytes(te) - fold_in
    assert fold_in <= 2.0 * sweeps * ue_bytes + SLACK, tf
    assert 0 < scoring <= 2.0 * input_bytes + SLACK, te


def test_sharded_spd_solve_issues_no_collective(runs):
    # the counterpart of test_pallas_leaf_partitions_over_batch: each rank
    # solves its block of the batch alone
    rng = np.random.default_rng(0)
    n, d = 256, 32
    x = rng.normal(size=(n, d + 3, d)).astype(np.float32)
    a = np.einsum("nld,nle->nde", x, x) + 2.0 * np.eye(d, dtype=np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    ref = np.stack([np.linalg.solve(a[i], b[i]) for i in range(n)])
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
    assert _overlap(mids, sids) > 0.9
    u1, ids1 = runs["ranks"][1]["eval"]["served"]
    np.testing.assert_array_equal(mu, u1)
    np.testing.assert_array_equal(mids, ids1)
    # recommend() on the mesh: every rank returns every user
    ru, rids = runs["ranks"][0]["eval"]["recommended"]
    np.testing.assert_array_equal(ru, mu)
    assert _overlap(rids, mids) > 0.9
    np.testing.assert_array_equal(
        rids, runs["ranks"][1]["eval"]["recommended"][1])


def test_checkpoint_written_on_mesh_restores_in_one_process(runs):
    case = runs["cases"]["eval"]
    ds = _ds(case["pairs"])
    fresh = get_model("safer2", Config(**case["cfg"]), ds.num_users,
                      ds.num_items, device="cpu")
    state, epoch, meta = CheckpointManager(runs["ckpt"]).restore_with_meta(
        fresh.state, generator=fresh.generator)
    assert epoch == 1 and state is not None
    fresh.state = state
    fresh.load_checkpoint_meta(meta)
    got = fresh.export_state()
    want = runs["ranks"][0]["eval"]["state"]
    for f in ("user_emb", "item_emb", "user_loss", "dual_weight"):
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
    argv = _write_csvs(tmp_path, _tiny_pairs(tiny)) + ["--mesh", "2"]
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
    argv = _write_csvs(tmp_path, _tiny_pairs(tiny)) + ["--distributed", "1"]
    port = str(_free_port())
    procs = [_cli(argv, dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                             WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=port)) for r in range(2)]
    errs = _finish(procs)
    for rank, err in enumerate(errs):
        assert f"distributed: process {rank}/2, 2 global devices" in err
        _check_lines(err, rank, 2)
