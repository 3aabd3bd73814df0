"""The port's fixed-shape serving engine (serving.py) and the serving
half of the model surface, on the CPU: the ports of
tests/test_serving.py (all but the meshed case, which waits for the
port's multi-device work), the Server against ``recommend()`` for each
model, against the JAX package's Server on carried tables, across a
state change and over streams, ``recommend(approx=True)``, the decoded
solver-order ids, and the float32 precision pin of the entry points.

On the CPU a program is a plain callable over the same static buffers a
CUDA graph holds on the card; ``num_compiles`` counts them."""

import logging

import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.serving import Server as JServer
from safer2_recommender_tpu_torch import (CheckpointManager, Config, Dataset,
                                          DeviceData, FoldInData, Server,
                                          get_model, interop)

MODELS = ("ials", "ialspp", "erm_mf", "cvar_mf", "safer2", "safer2pp")


class _Records(logging.Handler):
    """The port's log records while attached (its logger stops
    propagating once the CLI has set it up, so caplog cannot see them)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        self._log = logging.getLogger("safer2_recommender_tpu_torch")
        self._level = self._log.level
        self._log.setLevel(logging.DEBUG)
        self._log.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._log.removeHandler(self)
        self._log.setLevel(self._level)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes and several worker processes side by side: one
    intra-op thread per process (results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_module():
    # the JAX module's data (tests/test_serving.py::tiny_module)
    rng = np.random.default_rng(42)
    pairs = np.unique(np.stack([rng.integers(0, 150, 4000),
                                rng.integers(0, 80, 4000)], 1),
                      axis=0).astype(np.int32)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds, device="cpu")


def _train(ds, dd, name="safer2", epochs=1, **cfg):
    cfg = dict(dict(dim=8, bandwidth=0.3, block_size=4), **cfg)
    m = get_model(name, Config(**cfg), ds.num_users, ds.num_items,
                  device="cpu")
    m.initialize(dd)
    for _ in range(epochs):
        m.train_epoch(dd)
    return m


@pytest.fixture(scope="module")
def trained(tiny_module):
    ds, dd = tiny_module
    return ds, dd, _train(ds, dd)


def _request(ds, n_users, seed, hist=6):
    rng = np.random.default_rng(seed)
    users = rng.choice(ds.num_users, size=n_users, replace=False)
    u = np.repeat(users, hist).astype(np.int32)
    i = rng.integers(0, ds.num_items, u.size).astype(np.int32)
    return Dataset(u, i)


def _mixed_request(ds, seed, n_short=30, n_long=12):
    """Users with 6 and with 70 history items (distinct pairs)."""
    rng = np.random.default_rng(seed)
    users = rng.choice(ds.num_users, size=n_short + n_long, replace=False)
    u, i = [], []
    for j, user in enumerate(users):
        h = 6 if j < n_short else 70
        u.append(np.full(h, user))
        i.append(rng.choice(ds.num_items, size=h, replace=False))
    return Dataset(np.concatenate(u).astype(np.int32),
                   np.concatenate(i).astype(np.int32))


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    return np.mean([np.intersect1d(x, y).size / x.size
                    for x, y in zip(a, b)])


# ---- ports of tests/test_serving.py -----------------------------------------


def test_server_matches_dynamic_recommend(trained):
    ds, dd, m = trained
    req = _request(ds, 40, seed=1)
    su, sids = Server(m, k=10).recommend(req)
    du, dids = m.recommend(req, k=10)
    np.testing.assert_array_equal(su, du)
    # the JAX package allows ULP-level reorderings here (> 0.95 overlap);
    # the port's padded solves agree bit for bit on the CPU
    assert _overlap(sids, dids) > 0.95
    np.testing.assert_array_equal(sids, dids)


def test_server_compile_once_across_varying_shapes(trained):
    ds, dd, m = trained
    srv = Server(m, k=5, batch_sizes=(64, 512), widths=(32, 128))
    for seed, n in enumerate((3, 17, 60, 41)):
        srv.recommend(_request(ds, n, seed=seed))
    assert srv.num_compiles == 1       # all fit the (64, 32) rung
    srv.recommend(_request(ds, 100, seed=9))
    assert srv.num_compiles == 2       # (512, 32) rung
    for seed, n in enumerate((5, 64, 120, 12), start=20):
        srv.recommend(_request(ds, n, seed=seed))
    assert srv.num_compiles == 2       # steady state: no new program
    assert srv.replays == 9


def test_server_ladder_extends_beyond_max_rung_width(trained):
    ds, dd, m = trained
    srv = Server(m, k=5, batch_sizes=(64,), widths=(8,))
    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(4, dtype=np.int32), 20)  # history 20 > 8
    items = rng.integers(0, ds.num_items, users.size).astype(np.int32)
    with _Records() as logged:
        u, ids = srv.recommend(Dataset(users, items))
    assert u.size == 4 and ids.shape == (4, 5)
    assert srv.num_compiles == 1
    assert list(srv.programs()) == [((64, 32),)]   # next power of two
    assert any("ladder extended to 32" in m for m in logged.messages)


def test_server_splits_oversized_batch(trained):
    ds, dd, m = trained
    small = Server(m, k=5, batch_sizes=(8,), widths=(32,))
    big = Server(m, k=5, batch_sizes=(64,), widths=(32,))
    req = _request(ds, 20, seed=4)
    su, sids = small.recommend(req)
    bu, bids = big.recommend(req)
    np.testing.assert_array_equal(su, bu)
    assert _overlap(sids, bids) > 0.95
    assert small.num_compiles == 1     # one 8-rung program, run 3x
    assert small.replays == 3


def test_server_stream_matches_loop(trained):
    ds, dd, m = trained
    srv = Server(m, k=5)
    reqs = [_request(ds, n, seed=s) for s, n in enumerate((12, 30, 7))]
    streamed = list(srv.recommend_stream(reqs))
    assert len(streamed) == 3
    for req, (u, ids) in zip(reqs, streamed):
        u2, ids2 = srv.recommend(req)
        np.testing.assert_array_equal(u, u2)
        np.testing.assert_array_equal(ids, ids2)


def test_server_empty_request(trained):
    ds, dd, m = trained
    srv = Server(m, k=5)
    u, ids = srv.recommend(Dataset(np.zeros(0, np.int32),
                                   np.zeros(0, np.int32)))
    assert u.shape == (0,) and ids.shape == (0, 5)
    assert srv.num_compiles == 0       # nothing dispatched


def test_server_rejects_out_of_catalog_items(trained):
    ds, dd, m = trained
    srv = Server(m, k=5)
    bad = np.array([0, ds.num_items], np.int32)   # one past the catalog
    with pytest.raises(ValueError, match="item ids"):
        srv.recommend(Dataset(np.zeros(2, np.int32), bad))
    with pytest.raises(ValueError, match="item ids"):
        srv.recommend((np.zeros(1, np.int32), np.array([-1], np.int32)))
    # raw arrays of different lengths are refused too (the JAX Server
    # takes them)
    with pytest.raises(ValueError, match="differ in shape"):
        srv.recommend((np.zeros(2, np.int32), np.zeros(3, np.int32)))
    assert srv.num_compiles == 0


def test_server_after_self_contained_restore(trained, tmp_path):
    # serving is id-correct from a checkpoint alone (no DeviceData in the
    # restoring model): the same programs give the same ids
    ds, dd, m = trained
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(m.state, epoch=1, meta=m.checkpoint_meta())

    m2 = get_model("safer2", m.cfg, ds.num_users, ds.num_items,
                   device="cpu")
    state, epoch, meta = mgr.restore_with_meta(m2.state)
    m2.state = state
    m2.load_checkpoint_meta(meta)

    req = _request(ds, 25, seed=6)
    u1, ids1 = Server(m, k=10).recommend(req)
    u2, ids2 = Server(m2, k=10).recommend(req)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(ids1, ids2)


# ---- the port's own -----------------------------------------------------------


@pytest.mark.parametrize("name,dim", [(n, 8) for n in MODELS]
                         + [("ialspp", 128), ("safer2pp", 128),
                            ("safer2", 128)])
def test_server_equals_recommend_for_each_model(tiny_module, name, dim):
    # exact, for every model; at dim 128 a bucket of width <= 64 solves
    # by Woodbury and a wider one directly (the ++ models: one exact
    # Woodbury solve against blockwise sweeps, two different results), so
    # the Server packs short and long histories apart
    ds, dd = tiny_module
    bs = 32 if dim == 128 else 4
    m = _train(ds, dd, name, dim=dim, block_size=bs, alpha=0.3)
    srv = Server(m, k=10)
    reqs = [_request(ds, 40, seed=11), _request(ds, 1, seed=12),
            _mixed_request(ds, seed=13)]
    for req in reqs:
        su, sids = srv.recommend(req)
        du, dids = m.recommend(req, k=10)
        np.testing.assert_array_equal(su, du)
        np.testing.assert_array_equal(sids, dids)
    split = m._fold_in_split()
    assert split == (64 if dim == 128 else None)
    # the mixed request: one bucket of width 128, or under the split its
    # short rows on the first request's program and its long ones on a
    # program of their own (one program per rung pair)
    assert list(srv.programs()) == [((64, 32),), ((64, 128),)]


def test_server_builds_no_program_when_long_rows_come_and_go(tiny_module):
    # at dim 128 short (<= 64 items) and long rows run as sub-batches of
    # their own: a batch with long rows, one without and one with only
    # long rows replay the programs of the rung pairs the first built
    ds, dd = tiny_module
    m = _train(ds, dd, dim=128, block_size=32)
    srv = Server(m, k=10)
    mixed = _mixed_request(ds, seed=13)
    srv.recommend(mixed)
    assert list(srv.programs()) == [((64, 32),), ((64, 128),)]
    n_long = 12 * 70
    longs = Dataset(mixed.user_ids[-n_long:], mixed.item_ids[-n_long:])
    for req in (_request(ds, 40, seed=11), longs, mixed):
        su, sids = srv.recommend(req)
        du, dids = m.recommend(req, k=10)
        np.testing.assert_array_equal(su, du)
        np.testing.assert_array_equal(sids, dids)
    assert srv.num_compiles == 2 and srv.replays == 6


@pytest.mark.parametrize("name,dim", [("safer2", 8), ("safer2pp", 128)])
def test_server_matches_jax_server_on_carried_tables(tiny_module, name,
                                                     dim):
    # SAFER2++ at dim 128: the JAX Server packs a batch as one bucket, so
    # its short rows (<= 64 items) run the block sweeps too; the port's
    # Server follows recommend() there (one exact Woodbury solve), and
    # agrees with the JAX Server on the long rows only
    ds, dd = tiny_module
    jds = jx.Dataset(ds.user_ids, ds.item_ids)
    jdd = jx.DeviceData.build(jds)
    cfg = dict(dim=dim, bandwidth=0.3)
    if dim == 128:
        cfg.update(block_size=32, alpha=0.3)
    jm = jx.get_model(name, jx.Config(**cfg), ds.num_users, ds.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    tm = get_model(name, Config(**cfg), ds.num_users, ds.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd, steps=1)
    req = _request(ds, 60, seed=7) if dim == 8 else _mixed_request(
        ds, seed=13)
    jreq = jx.Dataset(req.user_ids, req.item_ids)
    ju, jids = map(np.asarray, JServer(jm, k=10).recommend(jreq))
    tu, tids = Server(tm, k=10).recommend(req)
    np.testing.assert_array_equal(tu, ju)
    # the bound of tests/test_torch_safer2.py's recommend parity
    split = tm._fold_in_split()
    if split is None:
        assert (tids == jids).mean() >= 0.99
        return
    long = np.bincount(req.user_ids, minlength=ds.num_users)[tu] > split
    assert long.any() and not long.all()
    assert (tids[long] == jids[long]).mean() >= 0.99
    jrids = np.asarray(jm.recommend(jreq, k=10)[1])
    assert (tids == jrids).mean() >= 0.99
    assert (tids[~long] == jids[~long]).mean() < 0.9


def test_server_serves_the_new_state(tiny_module):
    # a Server built before one more epoch serves the state after it, in
    # the same programs (the shared buffers are refreshed in place)
    ds, dd = tiny_module
    m = _train(ds, dd, dim=128)      # a Woodbury fold-in: eig in the prep
    srv = Server(m, k=10)
    req = _request(ds, 30, seed=8)
    before = srv.recommend(req)[1]
    np.testing.assert_array_equal(before, m.recommend(req, k=10)[1])
    m.train_epoch(dd)
    after = srv.recommend(req)[1]
    np.testing.assert_array_equal(after, m.recommend(req, k=10)[1])
    assert not np.array_equal(before, after)
    assert srv.num_compiles == 1


def test_replays_count_the_captured_launches(trained):
    # on the card a capture counts no chol_inverse launch and each replay
    # counts the capture's; here a stand-in graph replays a program
    from safer2_recommender_tpu_torch.ops import block_chol

    class _Graph:
        def replay(self):
            pass

    ds, dd, m = trained
    srv = Server(m, k=5)
    req = _request(ds, 10, seed=40)
    want = srv.recommend(req)
    (prog,) = srv.programs().values()
    prog.out = prog.fn()
    prog.graph = _Graph()
    prog.capture_launches = {r: 0 for r in block_chol.KERNEL_SIZES}
    prog.capture_launches[32] = 3
    block_chol.reset_launches()
    for _ in range(2):
        got = srv.recommend(req)
    np.testing.assert_array_equal(got[1], want[1])
    assert dict(block_chol.LAUNCHES) == {8: 0, 16: 0, 32: 6, 64: 0}
    assert prog.replays == 2 and srv.replays == 3
    block_chol.reset_launches()


def test_server_stream_with_varying_batch_sizes(trained):
    ds, dd, m = trained
    srv = Server(m, k=7, batch_sizes=(8, 64))
    sizes = (1, 9, 64, 3, 70, 8)       # 70 splits into 64 + 6
    reqs = [_request(ds, n, seed=30 + s) for s, n in enumerate(sizes)]
    streamed = list(srv.recommend_stream(iter(reqs)))
    assert [u.size for u, _ in streamed] == list(sizes)
    for req, (u, ids) in zip(reqs, streamed):
        du, dids = m.recommend(req, k=7)
        np.testing.assert_array_equal(u, du)
        np.testing.assert_array_equal(ids, dids)
    assert srv.num_compiles == 2 and srv.replays == 7


def test_server_stream_yields_the_batch_before_a_failing_one(trained):
    # the JAX Server's stream drops the previous good batch when the next
    # one fails to dispatch; the port yields it first, then raises
    ds, dd, m = trained
    srv = Server(m, k=5)
    good = _request(ds, 10, seed=40)
    bad = Dataset(np.zeros(1, np.int32), np.array([ds.num_items], np.int32))
    stream = srv.recommend_stream([good, bad])
    u, ids = next(stream)
    np.testing.assert_array_equal(ids, srv.recommend(good)[1])
    with pytest.raises(ValueError, match="item ids"):
        next(stream)


# ---- ports of tests/test_metrics.py's recommend cases --------------------------


def test_recommend_approx_mode(tiny_module):
    # approx=True (TF32 scores and torch.topk on the card; f32 on the
    # CPU) keeps the serving invariants and agrees with the exact ranking
    ds, dd = tiny_module
    m = get_model("ials", Config(dim=8), ds.num_users, ds.num_items,
                  device="cpu")
    m.train_epoch(dd)
    hist = Dataset(ds.user_ids[:400], ds.item_ids[:400])
    users, exact = m.recommend(hist, k=5)
    users2, approx = m.recommend(hist, k=5, approx=True)
    assert np.array_equal(users, users2)
    assert (approx >= 0).all() and (approx < ds.num_items).all()
    by_user = {}
    for u, i in zip(hist.user_ids, hist.item_ids):
        by_user.setdefault(int(u), set()).add(int(i))
    overlaps = []
    for row, u in enumerate(users):
        s = set(approx[row].tolist())
        assert not (s & by_user[int(u)])
        overlaps.append(len(s & set(exact[row].tolist())) / 5.0)
    assert np.mean(overlaps) >= 0.7
    su, sids = Server(m, k=5, approx=True).recommend(hist)
    np.testing.assert_array_equal(su, users)
    assert _overlap(sids, exact) >= 0.7


def test_recommend_decodes_solver_order_ids(tiny_module):
    # the returned top-1, mapped into solver order, holds the
    # history-masked maximum of the score row computed by hand
    ds, dd = tiny_module
    m = get_model("ials", Config(dim=8), ds.num_users, ds.num_items,
                  device="cpu")
    m.train_epoch(dd)
    hist = Dataset(ds.user_ids[:300], ds.item_ids[:300])
    users, recs = m.recommend(hist, k=3)

    empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
    fold = m._permute_fold(FoldInData.build(hist, empty,
                                            num_items=ds.num_items,
                                            device="cpu"))
    ue = m._fold_in(m.state, fold).numpy()
    scores = ue @ m.state.item_emb.numpy().T
    excl = fold.excl.numpy()
    perm = dd.item_perm.numpy()
    for r in range(users.size):
        s = scores[r].copy()
        s[excl[r][excl[r] < ds.num_items]] = -np.inf
        assert np.isclose(s[perm[recs[r, 0]]], s.max(), rtol=1e-5)
    np.testing.assert_array_equal(Server(m, k=3).recommend(hist)[1], recs)


# ---- the precision pin ----------------------------------------------------------


def _precision():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_entry_points_pin_f32_and_restore_the_callers_setting(
        tiny_module, monkeypatch):
    ds, dd = tiny_module
    fold = FoldInData.build(ds, ds, num_items=ds.num_items, device="cpu")
    req = _request(ds, 20, seed=9)

    def run_all():
        m = get_model("safer2", Config(dim=8, bandwidth=0.3),
                      ds.num_users, ds.num_items, device="cpu")
        seen = []
        for hook in ("_note_perms", "_epoch", "_fold_in", "_fold_in_prep"):
            inner = getattr(m, hook)

            def spy(*a, _inner=inner, **kw):
                seen.append(_precision())
                return _inner(*a, **kw)
            monkeypatch.setattr(m, hook, spy)
        m.initialize(dd)
        m.train_epoch(dd)
        m.train_epochs(dd, 2)
        res = m.evaluate_dataset(fold)
        rec = m.recommend(req, k=10)
        srv = Server(m, k=10).recommend(req)
        return seen, res, rec, srv

    base_seen, base_res, base_rec, base_srv = run_all()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert _precision()[:2] == ("high", True)
        seen, res, rec, srv = run_all()
        # the caller's setting is back after every entry point
        assert _precision()[:2] == ("high", True)
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(seen) == len(base_seen) >= 8
    assert set(seen) == {("highest", False, False)}
    # and a caller's "high" changes no score the library computes
    np.testing.assert_array_equal(res.ndcg, base_res.ndcg)
    np.testing.assert_array_equal(rec[1], base_rec[1])
    np.testing.assert_array_equal(srv[1], base_srv[1])
