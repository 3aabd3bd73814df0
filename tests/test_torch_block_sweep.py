"""The ops the five models beside SAFER2 added to the port, each against
its JAX function on the same numpy inputs, on the CPU:
``block_sweep_frozen`` route by route, ``exact_quantile``,
``woodbury.solve_rhs``, ``wide_matvec``, ``wide_gram_resid``,
``grad_from_params``, ``params_ials`` / ``ials_reg``. The bound, unless
stated: rtol 2e-4, atol 2e-5 * max(1, dim / 8), the float64 oracles'
own (tests/test_numpy_oracle.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.models import common as jcommon
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu.ops import quantile as jq
from safer2_recommender_tpu.ops import woodbury as jwb
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          get_model)
from safer2_recommender_tpu_torch.models import common as tcommon
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import quantile as tq
from safer2_recommender_tpu_torch.ops import woodbury as twb

# reference safer2_test.cc:17-27
SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _atol(dim):
    return 2e-5 * max(1, dim / 8)


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


def _both(pairs, **kw):
    pairs = np.unique(pairs, axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds, **kw), ds,
            DeviceData.build(ds, device="cpu", **kw))


@pytest.fixture(scope="module")
def small():
    """The oracle's dataset (tests/test_numpy_oracle.py::small), built by
    both packages."""
    rng = np.random.default_rng(42)
    return _both(np.stack([rng.integers(0, 90, 2500),
                           rng.integers(0, 40, 2500)], 1))


@pytest.fixture(scope="module")
def hot():
    """One item with 600 users (a width-1024 bucket) and a tail
    (tests/test_torch_woodbury.py::hot)."""
    rng = np.random.default_rng(2)
    hot_ = np.stack([np.arange(600), np.zeros(600, dtype=np.int64)], 1)
    tail = np.stack([rng.integers(0, 600, 5000),
                     rng.integers(1, 80, 5000)], 1)
    return _both(np.concatenate([hot_, tail]))


def _patch_wide(monkeypatch, chunk=256):
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(mod, "WIDE_CHUNK", chunk)


# --------------------------------------------------------------------------
# block_sweep_frozen, route by route, against the JAX function
# --------------------------------------------------------------------------


def _short_history_data():
    """Histories of 3..8 items: every user bucket has width 8."""
    rng = np.random.default_rng(17)
    us, its = [], []
    for u in range(150):
        hist = rng.choice(40, size=rng.integers(3, 9), replace=False)
        us += [u] * len(hist)
        its += list(hist)
    return np.stack([us, its], 1)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("route", ["plain", "block_woodbury", "full_woodbury",
                                   "ragged", "wide"])
def test_block_sweep_frozen_matches_jax(route, side, monkeypatch):
    # the SAFER2++ user sweep (ch = w/|H|, cg = w*uobs) and item sweep
    # (slot weights z/|H| through extra_vec) on each route of one call;
    # 2 sweeps, so the carried predictions cross a sweep boundary
    dim, bs, n_sweeps, sweeps_path = {
        "plain": (16, 4, 2, "block"),
        "block_woodbury": (32, 16, 2, "block_woodbury"),
        "full_woodbury": (16, 4, 2, "woodbury"),
        "ragged": (16, 6, 2, "block"),
        "wide": (16, 4, 2, "wide"),
    }[route]
    if route in ("block_woodbury", "full_woodbury"):
        pairs = _short_history_data()
        if side == "item":
            pairs = pairs[:, ::-1]
    else:
        rng = np.random.default_rng(8)
        pairs = np.stack([rng.integers(0, 100, 4000),
                          rng.integers(0, 50, 4000)], 1)
    jds, jdd, ds, dd = _both(pairs)
    if route == "wide":
        _patch_wide(monkeypatch, chunk=8)
    rng = np.random.default_rng(4)
    nu, ni = ds.num_users, ds.num_items
    u = (rng.normal(size=(nu, dim)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(ni, dim)) * 0.3).astype(np.float32)
    dual = np.linspace(0.1, 1.0, nu).astype(np.float32)
    cfg = dict(SAFER_CFG, dim=dim, block_size=bs, seed=4)
    jm = jx.get_model("safer2pp", jx.Config(**cfg), nu, ni)
    tm = get_model("safer2pp", Config(**cfg), nu, ni, device="cpu")
    if side == "user":
        gram = v.T @ v
        targs = (_t(u), _t(v), dd.by_user, _t(gram), tm._spec_u(_t(dual)))
        jargs = (jnp.asarray(u), jnp.asarray(v), jdd.by_user,
                 jnp.asarray(gram), jm._spec_u(jnp.asarray(dual)))
        tkw, jkw, buckets = {}, {}, dd.by_user
    else:
        gram = u.T @ (u * dual[:, None])
        nd = tm._norm_dual(dd, _t(dual))
        targs = (_t(v), _t(u), dd.by_item, _t(gram), tm._spec_v(dd))
        jargs = (jnp.asarray(v), jnp.asarray(u), jdd.by_item,
                 jnp.asarray(gram), jm._spec_v(jdd))
        tkw, jkw = dict(extra_vec=nd), dict(extra_vec=jnp.asarray(nd.numpy()))
        buckets = dd.by_item
    if route == "full_woodbury":
        lam, q = np.linalg.eigh(gram.astype(np.float64))
        lam = np.maximum(lam, 0.0).astype(np.float32)
        q = q.astype(np.float32)
        tkw["eig"] = (_t(q), _t(lam))
        jkw["eig"] = (jnp.asarray(q), jnp.asarray(lam))
        assert all(twb.applicable(b.width, dim) for b in buckets)
    if route == "block_woodbury":
        assert all(2 * b.width <= bs for b in buckets)
    if route == "wide":
        assert any(tasm.is_wide(b, dim) for b in buckets)
    twb.reset_solve_paths()
    before = targs[0].clone()
    got = tcommon.block_sweep_frozen(*targs, bs=bs, n_sweeps=n_sweeps, **tkw)
    assert twb.SOLVE_PATHS[sweeps_path] > 0
    twb.reset_solve_paths()
    assert torch.equal(targs[0], before)       # a new table comes back
    want = jcommon.block_sweep_frozen(*jargs, bs=bs, n_sweeps=n_sweeps,
                                      **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=_atol(dim))
    assert np.abs(got.numpy() - targs[0].numpy()).max() > 1e-3


def test_block_sweep_frozen_refuses_slabs_with_an_extra_vec(small):
    _, _, ds, dd = small
    m = get_model("safer2pp", Config(dim=8, block_size=4), ds.num_users,
                  ds.num_items, device="cpu")
    s = m.state
    with pytest.raises(ValueError, match="extra_vec"):
        tcommon.block_sweep_frozen(
            s.item_emb, s.user_emb, dd.by_item, s.item_gramian,
            m._spec_v(dd), bs=4, extra_vec=s.dual_weight,
            pre_list=[None] * len(dd.by_item))
    out = tcommon.block_sweep_frozen(s.user_emb, s.item_emb, (),
                                     s.item_gramian, None, bs=4)
    assert torch.equal(out, s.user_emb) and out is not s.user_emb


# --------------------------------------------------------------------------
# the ops this slice added, each against its JAX function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,alpha", [(90, 0.3), (90, 1.0), (90, 0.011),
                                     (7, 0.5), (5000, 0.3), (5000, 0.2048),
                                     (5000, 0.205)])
def test_exact_quantile_matches_jax(n, alpha):
    # ties (values rounded to 2 decimals), alpha == 1.0 clamped to the
    # smallest loss, int(n * alpha) rounding, and both sides of the
    # top-k / full-sort switch (q + 1 = 1024 and 1025 at n = 5000)
    assert tq._TOPK_MAX_K == jq._TOPK_MAX_K == 1024
    rng = np.random.default_rng(n)
    loss = np.round(rng.gamma(2.0, 0.3, n), 2).astype(np.float32)
    got = tq.exact_quantile(_t(loss), alpha)
    assert got.shape == () and got.dtype == torch.float32
    want = float(jq.exact_quantile(jnp.asarray(loss), alpha))
    assert float(got) == want
    q = min(int(n * alpha), n - 1)
    assert float(got) == np.sort(loss)[n - 1 - q]


def _rhs_case(rng, n=12, l=6, d=128):
    g = rng.normal(size=(d, d)).astype(np.float32)
    gram = (g @ g.T / d).astype(np.float32)
    length = rng.integers(1, l + 1, size=n)
    mask = (np.arange(l)[None, :] < length[:, None]).astype(np.float32)
    emb = rng.normal(size=(n, l, d)).astype(np.float32) * mask[:, :, None]
    wt = rng.uniform(0.05, 2.0, size=(n, l)).astype(np.float32) * mask
    c0 = rng.uniform(0.05, 0.2, size=n).astype(np.float32)
    c1 = rng.uniform(0.001, 0.05, size=n).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    return emb, wt, c0, c1, b, gram


@pytest.mark.parametrize("d,l", [(128, 6), (16, 8), (32, 3)])
def test_woodbury_solve_rhs_matches_jax_and_dense(d, l):
    # an arbitrary rhs (the delta systems'); d 16 and 32 are the block
    # sizes of the block-level Woodbury
    emb, wt, c0, c1, b, gram = _rhs_case(np.random.default_rng(d), l=l, d=d)
    lam, q = np.linalg.eigh(gram.astype(np.float64))
    lam = np.maximum(lam, 0.0).astype(np.float32)
    q = q.astype(np.float32)
    got = twb.solve_rhs(_t(emb), _t(wt), _t(c0), _t(c1), _t(b), _t(q),
                        _t(lam)).numpy()
    jgot = np.asarray(jwb.solve_rhs(*(jnp.asarray(x) for x in
                                      (emb, wt, c0, c1, b, q, lam))))
    e, w = emb.astype(np.float64), wt.astype(np.float64)
    a = (np.einsum("nld,nl,nle->nde", e, w, e)
         + c1[:, None, None] * gram.astype(np.float64)
         + c0[:, None, None] * np.eye(d))
    want = np.linalg.solve(a, b.astype(np.float64)[..., None])[..., 0]
    # the JAX package's own Woodbury-vs-direct bound (tests/test_ops.py)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got, jgot, rtol=5e-3, atol=5e-4)
    scale = np.abs(want).max()
    assert np.abs(got - jgot).max() / scale < 1e-3


def test_wide_matvec_and_gram_resid_match_jax(hot, monkeypatch):
    _patch_wide(monkeypatch)
    jds, jdd, ds, dd = hot
    d = 16
    rng = np.random.default_rng(3)
    users = rng.normal(size=(ds.num_users, d)).astype(np.float32)
    vec = rng.uniform(0.1, 1.0, ds.num_users).astype(np.float32)
    wide = [(t, j) for t, j in zip(dd.by_item, jdd.by_item)
            if tasm.is_wide(t, d)]
    assert wide and any(t.width > 256 for t, _ in wide)
    for tb, jb in wide:
        x = rng.normal(size=(tb.n_rows, d)).astype(np.float32) * 0.1
        for tv, jv in ((None, None), (_t(vec), jnp.asarray(vec))):
            for fn in ("wide_matvec", "wide_gram_resid"):
                got = getattr(tasm, fn)(_t(users), tb, _t(x), extra_vec=tv)
                want = getattr(jasm, fn)(jnp.asarray(users), jb,
                                         jnp.asarray(x), extra_vec=jv)
                # f32 sums over up to 1024 slots in 256-wide chunks
                for g_, w_ in zip(got, want):
                    np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                               rtol=1e-5, atol=1e-4)
        # the streamed pieces are the whole-bucket gather's
        emb, mask = tasm.gather_history(_t(users), tb)
        s_full, r0 = tasm.wide_gram_resid(_t(users), tb, _t(x))
        np.testing.assert_allclose(s_full.numpy(),
                                   tasm.row_gramians(emb).numpy(),
                                   rtol=1e-5, atol=1e-4)
        resid = tasm.rowwise_dot(emb, _t(x)) - mask
        np.testing.assert_allclose(
            r0.numpy(), tasm.row_sums(emb, col_weight=resid).numpy(),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("wide", [False, True])
def test_grad_from_params_matches_jax(hot, monkeypatch, wide):
    # A @ x - rhs by matvecs, for the user-side (row_coef) and the
    # item-side (extra_vec) parameterizations; equal to the assembled
    # system's (A + c0 I) x - rhs
    jds, jdd, ds, dd = hot
    d = 16
    if wide:
        _patch_wide(monkeypatch)
    rng = np.random.default_rng(9)
    users = (rng.normal(size=(ds.num_users, d)) * 0.3).astype(np.float32)
    items = (rng.normal(size=(ds.num_items, d)) * 0.3).astype(np.float32)
    norm_dual = rng.uniform(0.0, 0.2, ds.num_users).astype(np.float32)
    cases = []
    for tb, jb in zip(dd.by_item, jdd.by_item):
        reg = rng.uniform(0.01, 0.1, tb.n_rows).astype(np.float32)
        cases.append((
            tcommon.params_weighted_item(_t(users), tb, _t(reg), 0.01,
                                         _t(norm_dual)),
            jcommon.params_weighted_item(jnp.asarray(users), jb,
                                         jnp.asarray(reg), 0.01,
                                         jnp.asarray(norm_dual)),
            users.T @ users, items, tb))
    for tb, jb in zip(dd.by_user, jdd.by_user):
        reg = np.full(tb.n_rows, 0.05, np.float32)
        w = rng.uniform(0.1, 1.0, tb.n_rows).astype(np.float32)
        cases.append((
            tcommon.params_weighted_mean(_t(items), tb, _t(reg), 0.01, _t(w)),
            jcommon.params_weighted_mean(jnp.asarray(items), jb,
                                         jnp.asarray(reg), 0.01,
                                         jnp.asarray(w)),
            items.T @ items, users, tb))
    assert any(tp.wide is not None for tp, *_ in cases) == wide
    for tp, jp, gram, table, tb in cases:
        assert (tp.wide is None) == (jp.wide is None)
        x = tasm.read_rows(_t(table), tb)
        got = tcommon.grad_from_params(tp, _t(gram), x)
        want = jcommon.grad_from_params(jp, jnp.asarray(gram),
                                        jnp.asarray(x.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        a, rhs = tcommon.assemble_from_params(tp, _t(gram))
        full = torch.bmm(a, x[:, :, None])[:, :, 0] + tp.c0[:, None] * x - rhs
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                                   atol=1e-4)
    twb.reset_solve_paths()


def test_ials_reg_and_params_ials_match_jax(small):
    jds, jdd, ds, dd = small
    rng = np.random.default_rng(1)
    items = rng.normal(size=(ds.num_items, 8)).astype(np.float32)
    for exp in (1.0, 0.7):
        for tb, jb in zip(dd.by_user, jdd.by_user):
            treg = tcommon.ials_reg(tb.length, ds.num_items, 0.003, exp, 0.1)
            jreg = jcommon.ials_reg(jb.length, ds.num_items, 0.003, exp, 0.1)
            np.testing.assert_allclose(treg.numpy(), np.asarray(jreg),
                                       rtol=1e-6)
            tp = tcommon.params_ials(_t(items), tb, treg, 0.1)
            jp = jcommon.params_ials(jnp.asarray(items), jb, jreg, 0.1)
            for name in ("emb", "wt", "r", "c0", "c1"):
                np.testing.assert_allclose(
                    getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                    rtol=1e-6, err_msg=name)
