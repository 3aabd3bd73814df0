"""The port's Woodbury path, eigenbasis refresh, rotated direct solves
and wide (column-chunked) assembly against the JAX package's, on the
same numpy inputs.

Eigenvectors are not unique (signs, and rotations inside degenerate
eigenspaces, differ between LAPACK builds and between packages), so
these tests compare solutions, reconstructions Q diag(lam) Q^T,
orthogonality and which refresh branch was taken, never Q itself."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.models import common as jcommon
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu.ops import woodbury as jwb
from safer2_recommender_tpu_torch import Config, Dataset, DeviceData
from safer2_recommender_tpu_torch import get_model, interop
from safer2_recommender_tpu_torch.models import common as tcommon
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import woodbury as twb


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _woodbury_case(rng, n=12, l=6, d=128, uniform_wt=False):
    """tests/test_ops.py::_woodbury_case as numpy arrays:
    (emb, wt, r, c0, c1, gram)."""
    g = rng.normal(size=(d, d)).astype(np.float32)
    gram = (g @ g.T / d).astype(np.float32)
    emb = rng.normal(size=(n, l, d)).astype(np.float32)
    length = rng.integers(1, l + 1, size=n)
    mask = (np.arange(l)[None, :] < length[:, None]).astype(np.float32)
    emb = emb * mask[:, :, None]
    wt = mask if uniform_wt else (
        rng.uniform(0.05, 2.0, size=(n, l)).astype(np.float32) * mask)
    r = rng.normal(size=(n, l)).astype(np.float32) * mask
    c0 = rng.uniform(0.01, 0.1, size=n).astype(np.float32)
    c1 = rng.uniform(0.001, 0.05, size=n).astype(np.float32)
    return emb, wt, r, c0, c1, gram


def _dense_solution(emb, wt, r, c0, c1, gram):
    e, w = emb.astype(np.float64), wt.astype(np.float64)
    a = (np.einsum("nld,nl,nle->nde", e, w, e)
         + c1[:, None, None] * gram.astype(np.float64)
         + c0[:, None, None] * np.eye(gram.shape[0]))
    rhs = np.einsum("nld,nl->nd", e, r.astype(np.float64))
    return np.linalg.solve(a, rhs[..., None])[..., 0]


def _recon(q, lam):
    q, lam = np.asarray(q, np.float64), np.asarray(lam, np.float64)
    return (q * lam[None, :]) @ q.T


def _coupling_ratio(g, q):
    """||B||^2 - sum_k ||B_kk||^2 over ||B||, B = Q^T G Q, 128-blocks."""
    b = q.T.astype(np.float64) @ g.astype(np.float64) @ q.astype(np.float64)
    b = 0.5 * (b + b.T)
    k = b.shape[0] // 128
    diag = sum(np.sum(b[i * 128:(i + 1) * 128, i * 128:(i + 1) * 128] ** 2)
               for i in range(k))
    total = np.linalg.norm(b)
    return np.sqrt(max(total ** 2 - diag, 0.0)) / total


@pytest.fixture()
def paths():
    twb.reset_solve_paths()
    yield twb.SOLVE_PATHS
    twb.reset_solve_paths()


@pytest.mark.parametrize("uniform_wt", [True, False])
def test_woodbury_solve_matches_jax(uniform_wt):
    rng = np.random.default_rng(0)
    emb, wt, r, c0, c1, gram = _woodbury_case(rng, uniform_wt=uniform_wt)
    want = _dense_solution(emb, wt, r, c0, c1, gram)
    jp = jwb.SolveParams(emb=jnp.asarray(emb), wt=jnp.asarray(wt),
                         r=jnp.asarray(r), c0=jnp.asarray(c0),
                         c1=jnp.asarray(c1))
    jeig = jwb.maybe_eigh(jnp.asarray(gram), 128, use_cg=False)
    jgot = np.asarray(jwb.solve(jp, *jeig))
    tp = twb.SolveParams(emb=_t(emb), wt=_t(wt), r=_t(r), c0=_t(c0),
                         c1=_t(c1))
    teig = twb.maybe_eigh(_t(gram), 128, use_cg=False)
    got = twb.solve(tp, *teig).numpy()
    # the JAX package's own Woodbury-vs-direct bound (tests/test_ops.py)
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got, jgot, rtol=5e-3, atol=5e-4)
    # c0 down to 0.01 makes the capacitance systems K + I condition ~1e4,
    # so any f32 rounding (each package's own eigh, the contraction
    # order) moves the solution by up to ~1e-3 of its largest entry
    scale = np.abs(want).max()
    assert np.abs(got - jgot).max() / scale < 2e-3
    assert np.abs(got - want).max() / scale < 2e-3


def _drifting_gramians(seed, d=256):
    """The JAX package's refresh test setup (tests/test_ops.py::
    test_refresh_eigh_warm_and_cold_paths): a decaying-spectrum Gramian
    and a few ALS-sized drifts of it."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(2000, d)).astype(np.float32) / np.sqrt(d)
    v *= (1.0 / np.sqrt(np.arange(1, d + 1)))[None, :].astype(np.float32)
    out = [v.T @ v]
    for _ in range(3):
        v = v + 0.02 * rng.normal(size=v.shape).astype(np.float32) * np.abs(v)
        out.append(v.T @ v)
    return [g.astype(np.float32) for g in out]


def test_refresh_eigh_warm_path_matches_jax(paths):
    gs = _drifting_gramians(3)
    q0 = np.linalg.eigh(gs[0].astype(np.float64))[1].astype(np.float32)
    jq, tq = jnp.asarray(q0), _t(q0)
    d = gs[0].shape[0]
    for g in gs[1:]:
        # tol 1: the coupling test always passes, both take the warm path
        jq, jlam = jwb.refresh_eigh(jnp.asarray(g), jq, 1.0)
        tq, tlam = twb.refresh_eigh(_t(g), tq, 1.0)
        rj, rt = _recon(jq, jlam), _recon(tq.numpy(), tlam.numpy())
        scale = np.linalg.norm(g)
        # the JAX package's bounds on its own warm path: orthogonal to
        # 1e-3, reconstruction within 5e-3 of the Gramian
        assert np.linalg.norm(tq.numpy().T @ tq.numpy() - np.eye(d)) < 1e-3
        assert np.linalg.norm(rt - g) / scale < 5e-3
        # both drop the same off-block coupling from the same basis, so
        # they agree far more closely than either does with g
        assert np.linalg.norm(rt - rj) / scale < 1e-4
    assert paths["refresh_warm"] == 3 and paths["refresh_cold"] == 0


def test_refresh_eigh_cold_path_and_threshold_match_jax(paths):
    gs = _drifting_gramians(4)
    q0 = np.linalg.eigh(gs[0].astype(np.float64))[1].astype(np.float32)
    g = gs[3]
    ratio = _coupling_ratio(g, q0)
    assert 1e-3 < ratio < 0.5
    # either side of the coupling (float64 here): the two packages take
    # the same branch, and the branch decides the reconstruction. Both
    # compute the coupling in f32 as sqrt(||B||^2 - sum ||B_kk||^2),
    # whose cancellation puts it within ~15% of the float64 value at
    # this size, so the two tolerances keep a 2x margin.
    for tol, branch in ((2.0 * ratio, "refresh_warm"),
                        (0.5 * ratio, "refresh_cold")):
        before = dict(paths)
        jq, jlam = jwb.refresh_eigh(jnp.asarray(g), jnp.asarray(q0), tol)
        tq, tlam = twb.refresh_eigh(_t(g), _t(q0), tol)
        assert paths[branch] == before[branch] + 1
        rj, rt = _recon(jq, jlam), _recon(tq.numpy(), tlam.numpy())
        assert np.linalg.norm(rt - rj) / np.linalg.norm(g) < 1e-4
        if branch == "refresh_cold":
            # the cold path is a full eigh: ascending eigenvalues and an
            # exact reconstruction (to f32)
            assert np.all(np.diff(tlam.numpy()) >= -1e-4)
            assert np.linalg.norm(rt - g) / np.linalg.norm(g) < 1e-5
    # an unrelated Gramian falls back to the full eigh at the default tol
    v2 = np.random.default_rng(5).normal(size=(2000, 256)).astype(np.float32)
    g2 = v2.T @ v2
    tq2, tlam2 = twb.refresh_eigh(_t(g2), _t(q0), 2e-3)
    assert paths["refresh_cold"] == 2
    assert np.linalg.norm(_recon(tq2.numpy(), tlam2.numpy()) - g2) \
        / np.linalg.norm(g2) < 1e-5


def test_maybe_eigh_and_applicable_gating(paths):
    # tests/test_ops.py::test_woodbury_gating, plus the refresh gate
    assert twb.maybe_eigh(torch.eye(8), 8, use_cg=False) is None
    assert twb.maybe_eigh(torch.eye(128), 128, use_cg=True) is None
    assert twb.applicable(64, 128)
    assert not twb.applicable(65, 128)
    # below _REFRESH_MIN_DIM, or with tol 0, or without a previous basis:
    # one plain eigh, no refresh
    g = torch.diag(torch.linspace(-1.0, 2.0, 256))
    for dim_, q_prev, tol in ((128, torch.eye(128), 8e-2),
                              (256, torch.eye(256), 0.0),
                              (256, None, 8e-2)):
        q, lam = twb.maybe_eigh(g[:dim_, :dim_], dim_, use_cg=False,
                                q_prev=q_prev, refresh_tol=tol)
        assert q.shape == (dim_, dim_) and (lam >= 0).all()
    assert paths["refresh_warm"] == paths["refresh_cold"] == 0
    # dim 256 with a basis and tol > 0 refreshes (a diagonal Gramian is
    # block diagonal in the identity basis: warm), and negative
    # eigenvalues are clamped to 0
    q, lam = twb.maybe_eigh(g, 256, use_cg=False, q_prev=torch.eye(256),
                            refresh_tol=8e-2)
    assert paths["refresh_warm"] == 1
    assert float(lam.min()) == 0.0


def test_assemble_rotated_matches_jax():
    rng = np.random.default_rng(1)
    emb, wt, r, c0, c1, gram = _woodbury_case(rng, l=40)
    lam, q = np.linalg.eigh(gram.astype(np.float64))
    q, lam = q.astype(np.float32), np.maximum(lam, 0).astype(np.float32)
    jp = jwb.SolveParams(emb=jnp.asarray(emb), wt=jnp.asarray(wt),
                         r=jnp.asarray(r), c0=jnp.asarray(c0),
                         c1=jnp.asarray(c1))
    tp = twb.SolveParams(emb=_t(emb), wt=_t(wt), r=_t(r), c0=_t(c0),
                         c1=_t(c1))
    want = jcommon.assemble_rotated(jp, (jnp.asarray(q), jnp.asarray(lam)))
    got = tcommon.assemble_rotated(tp, (_t(q), _t(lam)))
    # f32 sums over L = 40 rotated slots of O(10) values
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def dense():
    """Users with short histories (width <= 64: Woodbury at dim 128),
    30 items with long ones (width 256: the rotated direct path at dim
    128 and 256) and 50 with short ones (Woodbury), built by both
    packages."""
    rng = np.random.default_rng(11)
    pairs = np.unique(np.concatenate([
        np.stack([rng.integers(0, 300, 9000),
                  rng.integers(0, 30, 9000)], 1),
        np.stack([rng.integers(0, 300, 1500),
                  rng.integers(30, 80, 1500)], 1)]),
        axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"))


def _sweep_case(dense, dim, seed):
    jds, jdd, ds, dd = dense
    rng = np.random.default_rng(seed)
    users = (rng.normal(size=(ds.num_users, dim)) * 0.1).astype(np.float32)
    dual = rng.uniform(0.1, 1.0, ds.num_users).astype(np.float32)
    return users, dual


def test_solve_sweep_woodbury_and_rotated_match_direct(dense, paths):
    # tests/test_ops.py::test_solve_sweep_woodbury_matches_direct_path on
    # the port, item side: widths 16 (Woodbury) to 256 (rotated direct)
    _, _, ds, dd = dense
    d = 128
    users, dual = _sweep_case(dense, d, 0)
    u, dual_t = _t(users), _t(dual)
    w_gram = u.T @ (u * dual_t[:, None])
    norm_dual = dual_t / dd.user_hist_size.clamp(min=1.0)

    def params_fn(b, pre=None):
        reg = torch.full((b.n_rows,), 0.05)
        return tcommon.params_weighted_item(u, b, reg, 0.01, norm_dual)

    z = torch.zeros((ds.num_items, d))
    eig = twb.maybe_eigh(w_gram, d, use_cg=False)
    x_eig = tcommon.solve_sweep(z, dd.by_item, params_fn, w_gram, eig=eig)
    assert paths["woodbury"] > 0 and paths["rotated"] > 0
    assert paths["direct"] == 0
    x_direct = tcommon.solve_sweep(z, dd.by_item, params_fn, w_gram)
    assert paths["direct"] == sum(b.n_rows for b in dd.by_item)
    np.testing.assert_allclose(x_eig.numpy(), x_direct.numpy(), rtol=5e-3,
                               atol=5e-4)


@pytest.mark.parametrize("side", ["user", "item"])
def test_solve_sweep_with_eig_matches_jax(dense, side):
    jds, jdd, ds, dd = dense
    d = 128
    users, dual = _sweep_case(dense, d, 1)
    items = (np.random.default_rng(2).normal(size=(ds.num_items, d))
             * 0.3).astype(np.float32)
    if side == "user":
        other, n_rows = items, ds.num_users
        gram = items.T @ items
        tb, jb = dd.by_user, jdd.by_user

        def tparams(b, pre=None):
            w = _t(dual)[b.row_ids.clamp(max=n_rows - 1)]
            return tcommon.params_weighted_mean(
                _t(other), b, torch.full((b.n_rows,), 0.05), 0.01, w,
                pre=pre)

        def jparams(b, pre=None):
            w = jnp.asarray(dual)[jnp.minimum(b.row_ids, n_rows - 1)]
            return jcommon.params_weighted_mean(
                jnp.asarray(other), b, jnp.full((b.n_rows,), 0.05), 0.01,
                w, pre=pre)
    else:
        other, n_rows = users, ds.num_items
        gram = users.T @ (users * dual[:, None])
        norm_dual = dual / np.maximum(
            dd.user_hist_size.numpy(), 1.0).astype(np.float32)
        tb, jb = dd.by_item, jdd.by_item

        def tparams(b, pre=None):
            return tcommon.params_weighted_item(
                _t(other), b, torch.full((b.n_rows,), 0.05), 0.01,
                _t(norm_dual))

        def jparams(b, pre=None):
            return jcommon.params_weighted_item(
                jnp.asarray(other), b, jnp.full((b.n_rows,), 0.05), 0.01,
                jnp.asarray(norm_dual))
    z = np.zeros((n_rows, d), np.float32)
    teig = twb.maybe_eigh(_t(gram), d, use_cg=False)
    jeig = jwb.maybe_eigh(jnp.asarray(gram), d, use_cg=False)
    got = tcommon.solve_sweep(_t(z), tb, tparams, _t(gram), eig=teig)
    want = jcommon.solve_sweep(jnp.asarray(z), jb, jparams,
                               jnp.asarray(gram), eig=jeig)
    # the f32 parity bound of the SAFER2 oracle at dim 128
    # (2e-5 * dim / 8, tests/test_numpy_oracle.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5 * d / 8)


@pytest.fixture(scope="module")
def hot():
    """tests/test_data.py::test_wide_streamed_assembly_matches_dense's
    data: one item with 600 users (a width-1024 bucket) and a tail."""
    rng = np.random.default_rng(2)
    hot_ = np.stack([np.arange(600), np.zeros(600, dtype=np.int64)], 1)
    tail = np.stack([rng.integers(0, 600, 5000),
                     rng.integers(1, 80, 5000)], 1)
    pairs = np.unique(np.concatenate([hot_, tail]), axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"))


def _patch_wide(monkeypatch):
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(mod, "WIDE_CHUNK", 256)


def test_wide_assemble_and_obs_match_jax(hot, monkeypatch):
    _patch_wide(monkeypatch)
    jds, jdd, ds, dd = hot
    d = 16
    rng = np.random.default_rng(3)
    users = rng.normal(size=(ds.num_users, d)).astype(np.float32)
    vec = rng.uniform(0.1, 1.0, ds.num_users).astype(np.float32)
    coef = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    wide = [(t, j) for t, j in zip(dd.by_item, jdd.by_item)
            if tasm.is_wide(t, d)]
    assert wide and any(t.width > 256 for t, _ in wide)
    for tb, jb in wide:
        init = rng.normal(size=(tb.n_rows, d, d)).astype(np.float32)
        c = coef[:1].repeat(tb.n_rows)
        got = tasm.wide_assemble(_t(users), tb, extra_vec=_t(vec),
                                 row_coef=_t(c), init_a=_t(init).clone())
        want = jasm.wide_assemble(jnp.asarray(users), jb,
                                  extra_vec=jnp.asarray(vec),
                                  row_coef=jnp.asarray(c),
                                  init_a=jnp.asarray(init))
        # f32 sums over up to 1024 history slots in 256-wide chunks
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                       rtol=1e-5, atol=1e-4)
        probe = rng.normal(size=(tb.n_rows, d)).astype(np.float32) * 0.1
        np.testing.assert_allclose(
            tasm.wide_obs(_t(users), tb, _t(probe)).numpy(),
            np.asarray(jasm.wide_obs(jnp.asarray(users), jb,
                                     jnp.asarray(probe))),
            rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dim", [16, 128])
def test_wide_safer2_epoch_matches_dense_and_jax(hot, monkeypatch, dim):
    # tests/test_data.py::test_wide_streamed_assembly_matches_dense for
    # SAFER2 on both packages; at dim 128 the wide buckets share direct
    # batches that are then solved unrotated
    jds, jdd, ds, dd = hot
    cfg = dict(dim=dim, bandwidth=0.15, alpha=0.3, seed=5,
               compute_dtype="f32")

    def run():
        jm = jx.get_model("safer2", jx.Config(**cfg), jds.num_users,
                          jds.num_items)
        jm.initialize(jdd)
        tm = get_model("safer2", Config(**cfg), ds.num_users, ds.num_items,
                       device="cpu")
        interop.state_from_jax(jm.export_state(jdd), tm, dd)
        jm.train_epoch(jdd)
        tm.train_epoch(dd)
        return tm.export_state(dd), jm.export_state(jdd)

    t_dense, _ = run()
    twb.reset_solve_paths()
    _patch_wide(monkeypatch)
    t_wide, j_wide = run()
    assert twb.SOLVE_PATHS["wide"] > 0
    if dim == 128:
        assert twb.SOLVE_PATHS["woodbury"] > 0
    monkeypatch.undo()
    twb.reset_solve_paths()
    atol = 2e-5 * max(1, dim / 8)
    for name in ("item_emb", "user_emb", "user_loss"):
        np.testing.assert_allclose(t_wide[name], t_dense[name], rtol=2e-4,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(t_wide[name], j_wide[name], rtol=2e-4,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("slab", [1, 40_000])
def test_solve_groups_match_jax(hot, monkeypatch, slab):
    # the same buckets, cut by the two packages: a wide bucket is costed
    # at min(width, WIDE_CHUNK) columns in both
    jds, _, ds, _ = hot
    dim = 16
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", slab)
    jdd = jx.DeviceData.build(jds, dim=dim, memory_budget_bytes=1 << 16)
    dd = DeviceData.build(ds, device="cpu", dim=dim,
                          memory_budget_bytes=1 << 16)
    for tbs, jbs in ((dd.by_user, jdd.by_user), (dd.by_item, jdd.by_item)):
        assert [b.n_rows for b in tbs] == [b.n_rows for b in jbs]
        got = tcommon._solve_groups(tbs, dim, budget_bytes=1 << 17)
        pos = {id(b): i for i, b in enumerate(jbs)}
        want = [[pos[id(b)] for b in g]
                for g in jcommon._solve_groups(jbs, dim, budget_bytes=1 << 17)]
        assert got == want
        assert len(got) > 1
        # the direct batches: buckets that repeat a shape run alone (one
        # scan step each in the JAX package), the rest as above
        singles = [b for b in jcommon.group_same_shape(jbs)
                   if not isinstance(b, jcommon.BucketStack)]
        alone = [[i] for i, b in enumerate(jbs) if id(b) not in
                 {id(s) for s in singles}]
        want = alone + [[pos[id(b)] for b in g] for g in
                        jcommon._solve_groups(singles, dim)]
        assert sorted(tcommon._direct_groups(tbs, dim)) == sorted(want)
    if slab == 1:
        assert any(tasm.is_wide(b, dim) for b in dd.by_item)
