"""The cases that hold the port's multi-device path to the JAX package's
mesh, shared by the 2-rank (tests/test_torch_distributed.py) and the
8-rank (tests/test_torch_mesh8.py) modules.

The JAX side draws the initial tables; ``interop.state_from_jax``
carries them into every port run, so the three epochs (JAX mesh, port
ranks, one port process) start equal. The bounds are the JAX package's
own for its sharded-vs-single tests (tests/test_multidevice.py): rtol
5e-3, atol 5e-5 on tables and losses, rtol 5e-3, atol 5e-4 on metrics,
and its collective-byte budgets.

``run_all`` makes every S-rank run of a module in ONE spawn, while the
parent computes the JAX side: a spawn, not an epoch, is what costs here.
Rendezvous is a file store in a temporary directory, so parallel test
workers never collide on a port; each rank runs one intra-op thread."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from safer2_recommender_tpu_torch import (CheckpointManager, Config,
                                          Dataset, DeviceData, FoldInData,
                                          Server, get_model, interop,
                                          parallel)
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.parallel import audit
from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.probes import serving_scale

MODELS = ("ials", "ialspp", "erm_mf", "cvar_mf", "safer2", "safer2pp")
RTOL, ATOL = 5e-3, 5e-5
METRIC_RTOL, METRIC_ATOL = 5e-3, 5e-4
SPAWN_TIMEOUT_S = 600
SLACK = 256 * 1024     # Gramian-size and scalar traffic at tiny scale
# test_multidevice.py:139-173
EPOCH_BUDGETS = {"safer2": 3.0, "safer2pp": 2.5, "ials": 3.0}
AUDIT_CFG = dict(dim=16, block_size=8, compute_dtype="f32")
EVAL_CFG = dict(dim=8, bandwidth=0.3)
EPOCH_KEYS = MODELS + ("woodbury", "rotated")
LAUNCH_KEYS = EPOCH_KEYS + ("safer2pp_interleaved", "ialspp_interleaved")
STATE_FIELDS = ("user_emb", "item_emb", "user_loss", "dual_weight")


def tiny_pairs(tiny) -> np.ndarray:
    ds, _ = tiny
    return np.stack([ds.user_ids, ds.item_ids], 1)


def rotated_pairs() -> np.ndarray:
    # test_multidevice.py:228-256: one user wider than dim / 2 takes the
    # eigenbasis-rotated direct path
    rng = np.random.default_rng(7)
    hot = np.stack([np.zeros(150, np.int64), np.arange(150)], 1)
    tail = np.stack([rng.integers(1, 120, 2000),
                     rng.integers(0, 150, 2000)], 1)
    return np.unique(np.concatenate([hot, tail]), axis=0).astype(np.int32)


def request(pairs, n_users, seed, hist=6):
    """test_serving.py::_request on the pairs' id universe."""
    rng = np.random.default_rng(seed)
    users = rng.choice(int(pairs[:, 0].max()) + 1, size=n_users,
                       replace=False)
    u = np.repeat(users, hist).astype(np.int32)
    i = rng.integers(0, int(pairs[:, 1].max()) + 1, u.size).astype(np.int32)
    return np.stack([u, i], 1)


def overlap(a, b) -> float:
    return np.mean([np.intersect1d(x, y).size / x.size
                    for x, y in zip(a, b)])


# --------------------------------------------------------------------------
# One run of a case: the same code in each rank and in the parent
# --------------------------------------------------------------------------


def ds_of(pairs) -> Dataset:
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
    ds = ds_of(case["pairs"])
    dim = case.get("build_dim", 0)
    dd = DeviceData.build(ds, device="cpu", dim=dim, mesh=mesh,
                          row_multiple=case.get("row_multiple", 8))
    m = get_model(case["model"], Config(**case["cfg"]), ds.num_users,
                  ds.num_items, device="cpu", mesh=mesh)
    if case.get("init") is not None:
        interop.state_from_jax(case["init"], m, dd, steps=0)
    else:
        m.initialize(dd)
    _reset(mesh)
    with probes.recorded_chol_shapes() as shapes:
        m.train_epoch(dd)
    out = {"state": m.export_state(dd), "epoch_traffic": _traffic(mesh),
           "chol_shapes": shapes}
    if "eval" in case:
        tr, te = (ds_of(p) for p in case["eval"])
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
        batch = ds_of(case["serve"])
        out["served"] = Server(m, k=10).recommend(batch)
        out["recommended"] = m.recommend(batch, k=10)
        # the rows where the Server and recommend() differ, and those of
        # them that differ by near-tie swaps only
        out["tie_rows"] = serving_scale.tie_rows(
            m, batch, out["served"][1], out["recommended"][1])
    if "ckpt" in case:
        CheckpointManager(case["ckpt"], mesh=mesh).save(
            m.state, 1, meta=m.checkpoint_meta(), generator=m.generator)
    return out


def solve_inputs():
    """One batch of SPD systems and right-hand sides."""
    rng = np.random.default_rng(0)
    n, d = 256, 32
    x = rng.normal(size=(n, d + 3, d)).astype(np.float32)
    a = np.einsum("nld,nle->nde", x, x) + 2.0 * np.eye(d, dtype=np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    return a, b


def _solve_block(mesh) -> dict:
    """The rank's rows of one batch of SPD systems through spd_solve."""
    a, b = solve_inputs()
    lo, hi = parallel.mesh.row_range(mesh, a.shape[0])
    _reset(mesh)
    got = block_chol.spd_solve(torch.from_numpy(a[lo:hi]),
                               torch.from_numpy(b[lo:hi]))
    return {"x": got.numpy(), "traffic": _traffic(mesh)}


def _blocks(mesh, pairs) -> list:
    """Per bucket of the pairs' DeviceData (users, then items): its
    padded rows over the mesh and the live rows of this rank's block."""
    dd = DeviceData.build(ds_of(pairs), device="cpu", mesh=mesh)
    return [(b.global_rows, int((b.length > 0).sum()))
            for b in dd.by_user + dd.by_item]


def rank_main(mesh, cases: dict, pairs) -> dict:
    """Every case of the module on one rank of the mesh."""
    torch.set_num_threads(1)
    out = {key: run_case(mesh, case) for key, case in cases.items()}
    out["spd_solve"] = _solve_block(mesh)
    out["blocks"] = _blocks(mesh, pairs)
    out["world_size"] = mesh.world_size
    return out


# --------------------------------------------------------------------------
# The JAX side and a module's runs
# --------------------------------------------------------------------------


def _jax_init(jx, jmesh, pairs, model, cfg, build_dim):
    """A JAX model initialized on the mesh, its DeviceData and its
    initial state (numpy, original id space)."""
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


def run_all(tiny, ckpt: str, n_ranks: int) -> dict:
    """Every case on ``n_ranks`` spawned gloo ranks, in one process and
    on the JAX package's mesh of the first ``n_ranks`` CPU devices."""
    import jax

    import safer2_recommender_tpu as jx
    from safer2_recommender_tpu.parallel import get_mesh

    assert jax.device_count() >= n_ranks, (
        f"needs {n_ranks} JAX devices (tests/conftest.py forces 8)")
    jmesh = get_mesh(jax.devices()[:n_ranks])
    pairs = tiny_pairs(tiny)
    eval_pairs = (pairs[::2], pairs[1::2])
    plan = {name: (pairs, name, dict(dim=8, block_size=4), 0, None)
            for name in MODELS}
    plan["woodbury"] = (pairs, "safer2", dict(dim=128), 128, None)
    plan["rotated"] = (rotated_pairs(), "safer2", dict(dim=128), 128, None)
    plan["eval"] = (pairs, "safer2", EVAL_CFG, 0, eval_pairs)

    # the JAX initial tables first (cheap), then the ranks run while the
    # JAX epochs compile and run here
    jax_models = {key: _jax_init(jx, jmesh, p, model, cfg, dim)
                  for key, (p, model, cfg, dim, _) in plan.items()}
    inits = {key: v[2] for key, v in jax_models.items()}
    cases = {key: dict(pairs=p, model=model, cfg=cfg, build_dim=dim,
                       init=inits[key])
             for key, (p, model, cfg, dim, _) in plan.items()}
    cases["eval"].update(eval=eval_pairs, serve=request(pairs, 30, seed=8),
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
            ranks = ex.submit(parallel.spawn, rank_main, n_ranks,
                              device="cpu", args=(cases, pairs),
                              timeout_s=SPAWN_TIMEOUT_S)
            jax_runs = {key: _jax_epoch(jx, jmesh, *jax_models[key][:2],
                                        plan[key][3], plan[key][4])
                        for key in plan}
            single = {key: run_case(None, {k: v for k, v in case.items()
                                           if k != "ckpt"})
                      for key, case in cases.items()
                      if not key.startswith("audit")}
            # one process on the mesh's bucket layout (rows padded to a
            # multiple of 8 x S, as every rank pads them): the solves
            # each rank's block belongs to
            layout = {key: run_case(None, dict(
                cases[key], row_multiple=8 * n_ranks))["chol_shapes"]
                for key in LAUNCH_KEYS}
            ranks = ranks.result()
    finally:
        torch.set_num_threads(threads)
    return dict(cases=cases, jax=jax_runs, single=single, ranks=ranks,
                ckpt=ckpt, layout_shapes=layout)


# --------------------------------------------------------------------------
# Checks shared by the modules
# --------------------------------------------------------------------------


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def ranks_equal(runs, key):
    """Every rank's state after the case's epoch bitwise rank 0's."""
    r0 = runs["ranks"][0][key]["state"]
    for r in runs["ranks"][1:]:
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(r[key]["state"][f], r0[f])
        assert r[key]["state"]["xi"] == r0["xi"]


def launches_are_the_layouts(runs, key, n_ranks):
    """Every rank hands the inverse-Cholesky wrapper its 1/S of each
    batch that one process solves on the mesh's bucket layout, in the
    same order, an all-padding block too; CVaR-MF takes gradient steps
    and solves nothing."""
    layout = runs["layout_shapes"][key]
    assert bool(layout) == (key != "cvar_mf")
    assert all(n % n_ranks == 0 for n, _, _ in layout)
    want = [(n // n_ranks, r, c) for n, r, c in layout]
    for r in runs["ranks"]:
        assert r[key]["chol_shapes"] == want
    return want


def epoch_collective_bytes_bounded(runs, tiny, name):
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


def eval_collective_bytes_bounded(runs, name):
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
