"""``compute_dtype="bf16"`` in the port against the JAX package, on the CPU.

Both packages gather the history slabs from bfloat16 tables and
accumulate their products in float32; tables, systems and solves stay
float32. The JAX package's ops run jitted here, as its models run them.
XLA's CPU backend then computes a bfloat16 product that feeds a
contraction exactly in float32 (the weighted operand of ``row_gramians``,
the Woodbury ``ws`` of ``_finish``) and rounds the rest where the source
rounds; the port's CPU route computes the same
(``ops/assemble.py::weight_operand``, ``ops/woodbury.py::_prep``).

An epoch is held to the JAX package's by one yardstick: per
table, the relative Frobenius gap between the port's bf16 epoch and the
JAX package's bf16 epoch is at most 1/10 of the JAX package's own
bf16-vs-f32 gap on the same input, which each test computes.

At dim >= 128 the bf16 rotation into the shared eigenbasis rounds in a
basis that float32 noise picks (an eigenvector is fixed only to about
eps / eigengap, and the ``dense`` fixture's Gramians are rank-deficient
at dim 128): carrying tables that differ by 1e-6 relative moved one of
the port's bf16 epochs by 0.56 (users) and 1.27 (items) of that gap,
while its f32 epoch moved by 2e-6. The dim-128 tests therefore hand the
port the bases the JAX model's sweeps used (its ``state.eig_qu`` /
``eig_qv`` after the epoch), with eigenvalues from the port's own
Gramian; everything else is the port's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import safer2_recommender_tpu as jx
from safer2_recommender_tpu.models import common as jcommon
from safer2_recommender_tpu.ops import assemble as jasm
from safer2_recommender_tpu.ops import woodbury as jwb
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, Server, get_model,
                                          interop)
from safer2_recommender_tpu_torch.checkpoint import CheckpointManager
from safer2_recommender_tpu_torch.models import common as tcommon
from safer2_recommender_tpu_torch.ops import assemble as tasm
from safer2_recommender_tpu_torch.ops import woodbury as twb

ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))

SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, stdev=0.1, alpha=0.3,
                 bandwidth=0.15, xi_iterations=5, pd_iterations=1)
IALS_CFG = dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0, stdev=0.1)
# the reference tests' configs (tests/test_models_ml1m.py)
MODEL_CFG = {
    "safer2": SAFER_CFG,
    "safer2pp": dict(SAFER_CFG, block_size=4),
    "ials": IALS_CFG,
    "ialspp": dict(IALS_CFG, block_size=4),
    "erm_mf": dict(uobs_weight=0.004, l2_reg=0.005, stdev=0.1, alpha=0.3),
    "cvar_mf": dict(uobs_weight=0.008, l2_reg=0.002, stdev=0.1, alpha=0.3,
                    stepsize=0.4),
}
GAP_SHARE = 0.1      # the port's bf16 gap to JAX, of JAX's bf16-vs-f32 gap
BF16_ULP = 2.0 ** -8  # one bfloat16 ulp, relative (8 significand bits)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bf16(x):
    """A float32 numpy array's values rounded to bfloat16, as float32."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, several test workers side by side: one intra-op
    thread per process (the results do not depend on it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def dense():
    """tests/test_torch_safer2.py::dense: users with short histories
    (Woodbury at dim >= 128), 30 items with long ones (the rotated
    direct path) and 50 with short ones, built by both packages."""
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


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


def _bucket_pair(dense, side, k):
    _, jdd, _, dd = dense
    by = "by_user" if side == "user" else "by_item"
    return getattr(dd, by)[k], getattr(jdd, by)[k]


@pytest.mark.parametrize("side,k", [("user", 0), ("item", 0), ("item", -1)])
def test_gathers_gramians_and_sums_match_jax(dense, side, k):
    tb, jb = _bucket_pair(dense, side, k)
    rng = np.random.default_rng(5)
    rows = 300 if side == "item" else 80
    table = rng.normal(size=(rows, 16)).astype(np.float32) * 0.3
    vec = rng.uniform(0.0, 0.01, rows).astype(np.float32)
    bf = torch.bfloat16

    emb, mask = tasm.gather_history(_t(table), tb, bf)
    jemb, jmask = jasm.gather_history(jnp.asarray(table), jb, jnp.bfloat16)
    assert emb.dtype == bf
    # the table is cast before the gather: the same bfloat16 values
    np.testing.assert_array_equal(emb.float().numpy(),
                                  np.asarray(jemb.astype(jnp.float32)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    e2, _, extra = tasm.gather_history_extra(_t(table), _t(vec), tb, bf)
    _, _, jextra = jasm.gather_history_extra(jnp.asarray(table),
                                             jnp.asarray(vec), jb,
                                             jnp.bfloat16)
    np.testing.assert_array_equal(e2.float().numpy(), emb.float().numpy())
    # the per-row scalar rides as a bfloat16 column: rounded, as in JAX
    assert extra.dtype == torch.float32
    np.testing.assert_array_equal(extra.numpy(), np.asarray(jextra))

    for wt in (None, extra, mask):
        jw = None if wt is None else jnp.asarray(wt.numpy())
        got_a = tasm.row_gramians(emb, wt)
        want_a = jax.jit(jasm.row_gramians)(jemb, jw)
        got_r = tasm.row_sums(emb, wt)
        want_r = jax.jit(jasm.row_sums)(jemb, jw)
        assert got_a.dtype == got_r.dtype == torch.float32
        # f32 accumulations of the same bfloat16-valued products
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                                   rtol=1e-5, atol=1e-6)


def _woodbury_inputs(seed, n=24, l=20, d=128):
    """tests/test_torch_woodbury.py::_woodbury_case with a bfloat16 slab
    and the small ridges of the item sweep (ill-conditioned K)."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(d, d)).astype(np.float32)
    gram = (g @ g.T / d).astype(np.float32)
    length = rng.integers(1, l + 1, size=n)
    mask = (np.arange(l)[None, :] < length[:, None]).astype(np.float32)
    emb = _bf16(rng.normal(size=(n, l, d)).astype(np.float32) * 0.1
                * mask[:, :, None])
    wt = _bf16(rng.uniform(0.0, 0.01, size=(n, l)).astype(np.float32)) * mask
    r = wt.copy()
    c0 = rng.uniform(0.001, 0.01, size=n).astype(np.float32)
    c1 = np.full(n, 0.004, np.float32)
    lam, q = np.linalg.eigh(gram.astype(np.float64))
    return (emb, wt, r, c0, c1, q.astype(np.float32),
            np.maximum(lam, 0).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_woodbury_ops_match_jax(seed):
    emb, wt, r, c0, c1, q, lam = _woodbury_inputs(seed)
    temb = _t(emb).to(torch.bfloat16)
    jemb = jnp.asarray(emb).astype(jnp.bfloat16)
    w, s, rs, ws, k = twb._prep(temb, _t(wt), _t(c0), _t(c1), _t(q),
                                _t(lam))
    jw_, js, jrs, jws, jk = jax.jit(jwb._prep)(
        jemb, jnp.asarray(wt), jnp.asarray(c0), jnp.asarray(c1),
        jnp.asarray(q), jnp.asarray(lam))
    # bfloat16 outputs: within one bfloat16 ulp (the f32 sums under them
    # run in another order, which may flip a rounding)
    assert w.dtype == torch.bfloat16
    np.testing.assert_allclose(w.float().numpy(),
                               np.asarray(jw_.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-30)
    np.testing.assert_allclose(ws.to(torch.bfloat16).float().numpy(),
                               np.asarray(jws.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-30)
    # f32 outputs at f32 tolerance
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=1e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-5 * float(np.abs(jk).max()))

    p = twb.SolveParams(emb=temb, wt=_t(wt), r=_t(r), c0=_t(c0), c1=_t(c1))
    jp = jwb.SolveParams(emb=jemb, wt=jnp.asarray(wt), r=jnp.asarray(r),
                         c0=jnp.asarray(c0), c1=jnp.asarray(c1))
    got = twb.solve(p, _t(q), _t(lam)).numpy()
    want = np.asarray(jax.jit(jwb.solve)(jp, jnp.asarray(q),
                                         jnp.asarray(lam)))
    # the bf16 solve's own error, against the f32 solve of the same data
    gap = _rel(want, np.asarray(jax.jit(jwb.solve)(
        jp._replace(emb=jemb.astype(jnp.float32)), jnp.asarray(q),
        jnp.asarray(lam))))
    assert _rel(got, want) <= GAP_SHARE * gap
    assert _rel(got, want) <= 1e-4

    b = np.random.default_rng(seed + 7).normal(
        size=(emb.shape[0], emb.shape[2])).astype(np.float32)
    got = twb.solve_rhs(temb, _t(wt), _t(c0), _t(c1), _t(b), _t(q),
                        _t(lam)).numpy()
    want = np.asarray(jax.jit(jwb.solve_rhs)(
        jemb, jnp.asarray(wt), jnp.asarray(c0), jnp.asarray(c1),
        jnp.asarray(b), jnp.asarray(q), jnp.asarray(lam)))
    assert _rel(got, want) <= 1e-4


def test_rotated_assembly_matches_jax():
    emb, wt, r, c0, c1, q, lam = _woodbury_inputs(3, n=8, l=200)
    p = twb.SolveParams(emb=_t(emb).to(torch.bfloat16), wt=_t(wt), r=_t(r),
                        c0=_t(c0), c1=_t(c1))
    jp = jwb.SolveParams(emb=jnp.asarray(emb).astype(jnp.bfloat16),
                         wt=jnp.asarray(wt), r=jnp.asarray(r),
                         c0=jnp.asarray(c0), c1=jnp.asarray(c1))
    got = tcommon.assemble_rotated(p, (_t(q), _t(lam)))
    want = jax.jit(jcommon.assemble_rotated)(
        jp, (jnp.asarray(q), jnp.asarray(lam)))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w_).max()))


@pytest.fixture(scope="module")
def hot():
    """tests/test_torch_woodbury.py::hot: one item with 600 users (a
    width-1024 bucket) and a tail."""
    rng = np.random.default_rng(2)
    hot_ = np.stack([np.arange(600), np.zeros(600, dtype=np.int64)], 1)
    tail = np.stack([rng.integers(0, 600, 5000),
                     rng.integers(1, 80, 5000)], 1)
    pairs = np.unique(np.concatenate([hot_, tail]), axis=0).astype(np.int32)
    jds = jx.Dataset(pairs[:, 0], pairs[:, 1])
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return (jds, jx.DeviceData.build(jds), ds,
            DeviceData.build(ds, device="cpu"))


def test_wide_chunks_match_jax(hot, monkeypatch):
    for mod in (jasm, tasm):
        monkeypatch.setattr(mod, "WIDE_SLAB_BYTES", 1)
        monkeypatch.setattr(mod, "WIDE_CHUNK", 256)
    jds, jdd, ds, dd = hot
    d = 16
    rng = np.random.default_rng(4)
    users = rng.normal(size=(ds.num_users, d)).astype(np.float32)
    vec = rng.uniform(0.0, 0.01, ds.num_users).astype(np.float32)
    wide = [(t, j) for t, j in zip(dd.by_item, jdd.by_item)
            if tasm.is_wide(t, d)]
    assert wide and any(t.width > 256 for t, _ in wide)
    bf, jbf = torch.bfloat16, jnp.bfloat16
    close = dict(rtol=1e-4, atol=1e-5)
    for tb, jb in wide:
        x = rng.normal(size=(tb.n_rows, d)).astype(np.float32) * 0.1
        coef = rng.uniform(0.5, 2.0, tb.n_rows).astype(np.float32)
        init = rng.normal(size=(tb.n_rows, d, d)).astype(np.float32)
        got = tasm.wide_assemble(_t(users), tb, extra_vec=_t(vec), dtype=bf,
                                 row_coef=_t(coef), init_a=_t(init).clone())
        want = jasm.wide_assemble(jnp.asarray(users), jb,
                                  extra_vec=jnp.asarray(vec), dtype=jbf,
                                  row_coef=jnp.asarray(coef),
                                  init_a=jnp.asarray(init))
        got += tasm.wide_matvec(_t(users), tb, _t(x), extra_vec=_t(vec),
                                dtype=bf)
        want += jasm.wide_matvec(jnp.asarray(users), jb, jnp.asarray(x),
                                 extra_vec=jnp.asarray(vec), dtype=jbf)
        got += tasm.wide_gram_resid(_t(users), tb, _t(x), dtype=bf)
        want += jasm.wide_gram_resid(jnp.asarray(users), jb, jnp.asarray(x),
                                     dtype=jbf)
        got += (tasm.wide_obs(_t(users), tb, _t(x), dtype=bf),)
        want += (jasm.wide_obs(jnp.asarray(users), jb, jnp.asarray(x),
                               dtype=jbf),)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.float32
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **close)
        # and the bf16 rounding is really there: f32 chunks differ
        f32 = tasm.wide_obs(_t(users), tb, _t(x))
        assert not torch.equal(f32, got[-1])


def test_gram_route_on_the_cpu_is_the_exact_upcast():
    assert tasm.gram_route(torch.device("cpu")) == "upcast"
    rng = np.random.default_rng(0)
    a = _t(_bf16(rng.normal(size=(3, 5, 7)).astype(np.float32)))
    b = _t(_bf16(rng.normal(size=(3, 7, 4)).astype(np.float32)))
    got = tasm.bmm_f32(a.to(torch.bfloat16), b.to(torch.bfloat16))
    assert got.dtype == torch.float32
    # bf16 x bf16 products are exact in f32: only the summation rounds
    want = np.einsum("nij,njk->nik", a.double().numpy(), b.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the rotation product comes out in bfloat16, rounded once
    q = _t(rng.normal(size=(7, 7)).astype(np.float32))
    rot = tasm.matmul_lowp(a.to(torch.bfloat16), q)
    assert rot.dtype == torch.bfloat16
    full = a.double().numpy() @ _bf16(q.numpy()).astype(np.float64)
    np.testing.assert_allclose(rot.float().numpy(), full, rtol=BF16_ULP,
                               atol=1e-6)


@pytest.mark.cuda
def test_gram_routes_agree_on_the_card():
    """On the card bmm_f32 multiplies bfloat16 operands by its route; it
    must agree with the float32 product of the same operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    a = torch.randn((64, 128, 96), generator=gen, device="cuda").bfloat16()
    got = tasm.bmm_f32(a.transpose(1, 2), a)
    want = torch.bmm(a.float().transpose(1, 2), a.float())
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, (tasm.gram_route(a.device), rel)


# --------------------------------------------------------------------------
# whole epochs from carried JAX tables
# --------------------------------------------------------------------------


def _jax_bases_for_port(monkeypatch, jm):
    """Make the port's sweeps use the JAX model's sweep bases, in the
    order its epoch took them (user sweep, then item sweep), with the
    port's own eigenvalues of its Gramian (see the module docstring)."""
    bases = [_t(jm.state.eig_qu), _t(jm.state.eig_qv)]
    calls = []

    def maybe_eigh(gram, dim, *, use_cg, q_prev=None, refresh_tol=0.0):
        assert not use_cg and dim >= twb.MIN_DIM
        q = bases[len(calls) % 2]
        calls.append(dim)
        return q, torch.clamp(torch.diagonal(q.T @ gram @ q), min=0.0)

    monkeypatch.setattr(twb, "maybe_eigh", maybe_eigh)
    return calls


def _bf16_epoch_gaps(dense, name, cfg_kw, monkeypatch=None):
    """One epoch of ``name`` from the JAX package's initial tables in
    both packages. Returns {table: (JAX bf16 vs JAX f32, port bf16 vs
    JAX bf16)} as relative Frobenius norms."""
    jds, jdd, ds, dd = dense
    out = {}
    for dt in ("f32", "bf16"):
        cfg = dict(cfg_kw, compute_dtype=dt, seed=5)
        jm = jx.get_model(name, jx.Config(**cfg), jds.num_users,
                          jds.num_items)
        jm.initialize(jdd)
        init = jm.export_state(jdd)
        jm.train_epoch(jdd)
        out[dt] = jm.export_state(jdd)
        if dt == "f32":
            continue
        tm = get_model(name, Config(**cfg), ds.num_users, ds.num_items,
                       device="cpu")
        assert tm.asm_dtype == torch.bfloat16
        interop.state_from_jax(init, tm, dd)
        calls = None
        if monkeypatch is not None:
            calls = _jax_bases_for_port(monkeypatch, jm)
        tm.train_epoch(dd)
        if calls is not None:
            assert len(calls) == 2
        out["port"] = tm.export_state(dd)
    return {k: (_rel(out["bf16"][k], out["f32"][k]),
                _rel(out["port"][k], out["bf16"][k]))
            for k in ("user_emb", "item_emb")}


def _assert_within_share(gaps):
    for k, (jax_gap, port_gap) in gaps.items():
        # the bf16 path is really taken: JAX's own gap is bf16-class
        assert jax_gap > 1e-4, (k, jax_gap)
        assert port_gap <= GAP_SHARE * jax_gap, (k, port_gap, jax_gap)


@pytest.mark.parametrize("name", sorted(MODEL_CFG))
def test_bf16_epoch_matches_jax_dim8(dense, name):
    _assert_within_share(_bf16_epoch_gaps(dense, name,
                                          dict(MODEL_CFG[name], dim=8)))


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_bf16_epoch_matches_jax_dim128(dense, name, monkeypatch):
    # Woodbury (users, short items) and rotated / blockwise (long items)
    cfg = dict(MODEL_CFG[name], dim=128, block_size=32)
    twb.reset_solve_paths()
    gaps = _bf16_epoch_gaps(dense, name, cfg, monkeypatch)
    assert twb.SOLVE_PATHS["woodbury"] > 0
    assert twb.SOLVE_PATHS["rotated" if name == "safer2" else "block"] > 0
    _assert_within_share(gaps)


@pytest.mark.parametrize("name,extra", [
    ("safer2pp", dict(block_interleaved=True)),
    ("ialspp", dict(block_interleaved=True)),
    ("safer2", dict(use_cg=True, cg_max_iterations=20)),
])
def test_bf16_interleaved_and_cg_match_jax(dense, name, extra):
    _assert_within_share(_bf16_epoch_gaps(
        dense, name, dict(MODEL_CFG[name], dim=8, **extra)))


# --------------------------------------------------------------------------
# the model surface under bf16
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_auto_is_f32_bit_for_bit(dense, name):
    _, _, ds, dd = dense
    states = {}
    for dt in ("auto", "f32"):
        m = get_model(name, Config(**dict(MODEL_CFG[name], dim=8,
                                          compute_dtype=dt)),
                      ds.num_users, ds.num_items, device="cpu")
        assert m.asm_dtype is None
        m.initialize(dd)
        m.train_epoch(dd)
        states[dt] = m.export_state(dd)
    for key in ("user_emb", "item_emb", "user_loss", "dual_weight"):
        np.testing.assert_array_equal(states["auto"][key],
                                      states["f32"][key])
    assert states["auto"]["xi"] == states["f32"]["xi"]
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model(name, Config(compute_dtype="fp16"), ds.num_users,
                  ds.num_items, device="cpu")


def test_entry_points_pin_bf16_reduction_and_restore(dense, monkeypatch):
    # cuBLAS may reduce a bfloat16 GEMM in bfloat16 unless told not to;
    # the entry points tell it not to and restore the caller's setting
    _, _, ds, dd = dense
    knob = torch.backends.cuda.matmul
    before = knob.allow_bf16_reduced_precision_reduction
    m = get_model("safer2", Config(**dict(SAFER_CFG, dim=8,
                                          compute_dtype="bf16")),
                  ds.num_users, ds.num_items, device="cpu")
    seen = []
    for hook in ("_epoch", "_fold_in"):
        inner = getattr(m, hook)

        def spy(*a, _inner=inner, **kw):
            seen.append(knob.allow_bf16_reduced_precision_reduction)
            return _inner(*a, **kw)
        monkeypatch.setattr(m, hook, spy)
    knob.allow_bf16_reduced_precision_reduction = True
    try:
        m.initialize(dd)
        m.train_epoch(dd)
        m.recommend(ds, k=5)
        Server(m, k=5).recommend(ds)
        assert knob.allow_bf16_reduced_precision_reduction is True
    finally:
        knob.allow_bf16_reduced_precision_reduction = before
    assert len(seen) >= 3 and not any(seen)


@pytest.fixture(scope="module")
def ml1m_bf16():
    """A JAX SAFER2 model at compute_dtype="bf16" after one epoch on
    ML-1M, and its tables carried into a port model of the same config."""
    jtrain = jx.Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    jval = [jx.Dataset.from_csv(os.path.join(ML1M_DIR, f))
            for f in ("validation_tr.csv", "validation_te.csv")]
    jdd = jx.DeviceData.build(jtrain)
    jfold = jx.FoldInData.build(*jval, num_items=jtrain.num_items)
    train = Dataset.from_csv(os.path.join(ML1M_DIR, "train.csv"))
    val = [Dataset.from_csv(os.path.join(ML1M_DIR, f))
           for f in ("validation_tr.csv", "validation_te.csv")]
    dd = DeviceData.build(train, device="cpu")
    fold = FoldInData.build(*val, num_items=train.num_items, device="cpu")
    cfg = dict(SAFER_CFG, dim=8, compute_dtype="bf16")
    jm = jx.get_model("safer2", jx.Config(**cfg), jtrain.num_users,
                      jtrain.num_items)
    jm.initialize(jdd)
    jm.train_epoch(jdd)
    exported = jm.export_state(jdd)
    tm = get_model("safer2", Config(**cfg), train.num_users,
                   train.num_items, device="cpu")
    interop.state_from_jax(exported, tm, dd, steps=1)
    return jm, jfold, tm, fold, exported, val[0]


def test_bf16_fold_in_and_recommend_match_jax(ml1m_bf16):
    jm, jfold, tm, fold, exported, val_tr = ml1m_bf16
    # the JAX package keeps f32 tables under bf16; carrying is exact
    assert exported["item_emb"].dtype == np.float32
    assert tm.state.item_emb.dtype == torch.float32
    np.testing.assert_array_equal(tm.export_state()["item_emb"],
                                  exported["item_emb"])
    want = jm.evaluate_dataset(jfold)
    got = tm.evaluate_dataset(fold)
    np.testing.assert_allclose(got.mean_recall(), want.mean_recall(),
                               atol=1e-3)
    np.testing.assert_allclose(got.mean_ndcg(), want.mean_ndcg(), atol=1e-3)
    sel = np.isin(val_tr.user_ids, np.unique(val_tr.user_ids)[:64])
    hist = Dataset(val_tr.user_ids[sel], val_tr.item_ids[sel])
    users, ids = tm.recommend(hist, k=10)
    jusers, jids = jm.recommend(jx.Dataset(hist.user_ids, hist.item_ids),
                                k=10)
    np.testing.assert_array_equal(users, jusers)
    assert (ids == np.asarray(jids)).mean() >= 0.99


def test_bf16_checkpoint_restores_and_serves(ml1m_bf16, tmp_path):
    _, _, tm, _, _, val_tr = ml1m_bf16
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tm.state, 1, meta=tm.checkpoint_meta(),
             generator=tm.generator)
    fresh = get_model("safer2", tm.cfg, tm.num_users, tm.num_items,
                      device="cpu")
    state, epoch, meta = mgr.restore_with_meta(fresh.state,
                                               generator=fresh.generator)
    assert epoch == 1
    fresh.state = state
    fresh.load_checkpoint_meta(meta)
    assert fresh.asm_dtype == torch.bfloat16
    sel = np.isin(val_tr.user_ids, np.unique(val_tr.user_ids)[:100])
    hist = Dataset(val_tr.user_ids[sel], val_tr.item_ids[sel])
    want = tm.recommend(hist, k=10)
    got = Server(fresh, k=10).recommend(hist)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
