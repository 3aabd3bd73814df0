"""The port's op-family probes (``probes/quantile.py``, ``gather.py``,
``eigh.py``, ``seqdot.py``) against the JAX package's scripts
(``scripts/probe_quantile.py``, ``probe_gather.py``,
``probe_gather_scatter.py``, ``probe_eigh.py``, ``probe_eigh2.py``,
``probe_seqdot.py``) on the CPU.

The scripts run at import, so their expressions are written out here
beside the port's variants, on the same numpy inputs; their sizes and
shape lists are read from their source with ``ast``. The timing runs
refuse the CPU.
"""

import ast
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.probes import (eigh, gather, oracle,
                                                 quantile, seqdot)
from safer2_recommender_tpu_torch.utils.device import matmul_precision

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several worker processes run the suite side by side: one intra-op
    thread each keeps them from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the scripts' sizes, read from their source ------------------------

@functools.lru_cache(maxsize=None)
def _tree(script):
    with open(os.path.join(SCRIPTS, script)) as f:
        return ast.parse(f.read())


_ARITHMETIC = (ast.Constant, ast.BinOp, ast.UnaryOp, ast.operator,
               ast.unaryop, ast.Name, ast.expr_context)


def _value(node, names=None):
    """A script's constant expression: numbers and arithmetic on them and
    on ``names``, tuples and lists of them, ``jnp.<dtype>`` read as the
    dtype's name, ``a if c else b`` as its default ``b``. ValueError (or
    NameError) for anything else."""
    if isinstance(node, ast.Attribute) and getattr(node.value, "id",
                                                   None) == "jnp":
        return node.attr
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(_value(e, names) for e in node.elts)
    if isinstance(node, ast.IfExp):
        return _value(node.orelse, names)
    if not all(isinstance(n, _ARITHMETIC) for n in ast.walk(node)):
        raise ValueError(ast.unparse(node))
    return eval(compile(ast.Expression(node), "<script>", "eval"),
                {"__builtins__": {}}, dict(names or {}))


def _assigned(script):
    """{name: value} of the script's assignments whose values evaluate."""
    out = {}
    for node in ast.walk(_tree(script)):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        try:
            value = _value(node.value, out)
        except (NameError, ValueError):
            continue
        if isinstance(target, ast.Name):
            out[target.id] = value
        elif isinstance(target, ast.Tuple):
            out.update({e.id: v for e, v in zip(target.elts, value)})
    return out


def _loops(script):
    """What each ``for`` loop of the script iterates over, where it
    evaluates."""
    out = []
    for node in ast.walk(_tree(script)):
        if isinstance(node, ast.For):
            try:
                out.append(_value(node.iter, _assigned(script)))
            except (NameError, ValueError):
                pass
    return out


def _keywords(script, name):
    """The values of keyword ``name`` in the script's calls, where they
    evaluate."""
    out = []
    for node in ast.walk(_tree(script)):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == name:
                    try:
                        out.append(_value(kw.value, _assigned(script)))
                    except (NameError, ValueError):
                        pass
    return out


def _defaults(script, func):
    fn = next(n for n in ast.walk(_tree(script))
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return {a.arg: _value(d) for a, d in zip(
        fn.args.args[len(fn.args.args) - len(fn.args.defaults):],
        fn.args.defaults)}


def test_quantile_sizes_are_the_script():
    got = _assigned("probe_quantile.py")
    assert (got["N"], got["ALPHA"]) == (quantile.N, quantile.ALPHA) \
        == (571_000, 0.3)
    assert quantile.selection(quantile.N, quantile.ALPHA) == 171_300


def test_gather_sizes_are_the_scripts():
    got = _assigned("probe_gather.py")
    assert (got["M"], got["SLOTS"]) == (gather.M, gather.SLOTS)
    assert tuple(gather.ROW_CASES) in _loops("probe_gather.py")
    both = _assigned("probe_gather_scatter.py")
    assert (both["rows"], both["dim"], both["n"], both["width"],
            both["sn"]) == (gather.TABLE_ROWS, gather.DIM, gather.BUCKET_N,
                            gather.WIDTH, gather.SCATTER_ROWS)


def test_eigh_sizes_are_the_scripts():
    assert _assigned("probe_eigh.py")["D"] == eigh.D
    assert (eigh.GRAM_ROWS, eigh.D) in _keywords("probe_eigh.py", "size")
    assert _keywords("probe_eigh.py", "length") == [eigh.NS_ITERS]
    assert tuple(eigh.SIZES) in _loops("probe_eigh2.py")


def test_seqdot_sizes_are_the_script():
    assert tuple(seqdot.DS) in _loops("probe_seqdot.py")
    assert _defaults("probe_seqdot.py", "per_iter")["ks"] == \
        probes.CHAIN_KS


@pytest.mark.parametrize("probe", [quantile, gather, eigh, seqdot, oracle],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_refuses_the_cpu(probe):
    with pytest.raises(ValueError, match="CUDA device"):
        probe.run(device="cpu")


@pytest.mark.parametrize("probe, argv", [
    (quantile, ["1000", "0.3"]), (gather, ["--part", "scatter"]),
    (eigh, ["--part", "sizes"]), (seqdot, None), (oracle, ["--dims", "8"])],
    ids=lambda p: getattr(p, "__name__", "").rsplit(".", 1)[-1])
def test_probe_main_exits_1_without_cuda(probe, argv, capsys, monkeypatch):
    # the command line refuses a machine without CUDA and prints no
    # reading
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = probe.main() if argv is None else probe.main(argv)
    assert rc == 1
    out, err = capsys.readouterr()
    assert out == "" and "NVIDIA GPU" in err


# -- probe_quantile.py ------------------------------------------------

def _jax_xi(x, n, q):
    """The script's two selections (``top_k``, ``sort``)."""
    xj = jnp.asarray(x)
    return (float(jax.lax.top_k(xj, q + 1)[0][q]),
            float(jnp.sort(xj)[n - 1 - q]))


@pytest.mark.parametrize("n, alpha", [(1000, 0.3), (5000, 0.01),
                                      (777, 1.0), (4096, 0.5)])
def test_quantile_variants_equal_jax(n, alpha):
    # alpha 0.01 takes exact_quantile's top-k branch, alpha 1.0 the clamp
    x = quantile.draw(n)
    q = quantile.selection(n, alpha)
    top_k, sort = _jax_xi(x, n, q)
    assert top_k == sort
    t = torch.from_numpy(x)
    got = {name: float(fn(t))
           for name, fn in quantile.variants(n, alpha).items()}
    assert set(got) == {"top_k", "sort", "kthvalue", "exact_quantile"}
    assert set(got.values()) == {sort}
    assert float(quantile.host_xi(x, alpha)) == sort


def test_quantile_at_the_scripts_n_equals_jax():
    n, alpha = quantile.N, quantile.ALPHA
    x = quantile.draw(n)
    assert np.array_equal(
        x, np.random.default_rng(0).standard_normal(n).astype(np.float32))
    q = quantile.selection(n, alpha)
    top_k, sort = _jax_xi(x, n, q)
    t = torch.from_numpy(x)
    variants = quantile.variants(n, alpha)
    assert float(variants["sort"](t)) == sort == top_k
    assert float(variants["exact_quantile"](t)) == sort
    assert float(quantile.host_xi(x, alpha)) == sort


# -- probe_gather.py ---------------------------------------------------

def _script_rows_draws():
    """``probe_gather.py:40-51``'s draws, as the script makes them."""
    m, slots = 4096, 1 << 19
    rng = np.random.default_rng(0)
    p = 1.0 / (np.arange(1, m + 1) ** 0.8)
    p /= p.sum()
    ids_rand = rng.choice(m, size=slots, p=p).astype(np.int32)
    ids_sorted_rows = ids_rand.reshape(-1, 128).copy()
    ids_sorted_rows.sort(axis=1)
    ids = [ids_rand, ids_sorted_rows.reshape(-1), np.sort(ids_rand)]
    tables = [(d, dt, jnp.asarray(rng.normal(size=(m, d)), dtype=dt))
              for d, dt in [(32, jnp.float32), (32, jnp.bfloat16),
                            (128, jnp.float32), (128, jnp.bfloat16),
                            (256, jnp.bfloat16)]]
    return ids, tables


@pytest.fixture(scope="module")
def rows_draws():
    return gather.rows_inputs(), _script_rows_draws()


def _bits(x):
    """The bits of a float32 or bfloat16 array (torch or JAX)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("case", range(len(gather.ROW_CASES)))
def test_row_gathers_equal_jax(rows_draws, case):
    # the port's tables are the script's, bf16 rounding of the float64
    # draws included, and its gather equals jnp's bit for bit in every
    # order (the first 8,192 slots of each)
    (ids, tables), (script_ids, script_tables) = rows_draws
    d, dt, tbl = tables[case]
    sd, sdt, stbl = script_tables[case]
    assert (d, dt) == (sd, sdt.__name__)
    table = gather.to_device(tbl, dt, "cpu")
    assert np.array_equal(_bits(table), _bits(stbl))
    for order, sids in zip(gather.ORDERS, script_ids):
        assert np.array_equal(ids[order], sids)
        sl = sids[:8192]
        sl_t = torch.from_numpy(sl.astype(np.int64))
        got = gather.gather_rows(table, sl_t)
        assert np.array_equal(_bits(got), _bits(stbl[jnp.asarray(sl)]))
        assert torch.equal(gather.index_select_rows(table, sl_t), got)
        host = gather._host_table(tbl, table.dtype)
        assert gather.host_equal(got, host, sl, np.arange(0, 8192, 7))


# -- probe_gather_scatter.py -------------------------------------------

def test_bucket_inputs_are_the_scripts_draws():
    table, ids, vals, rid = gather.bucket_inputs()
    rng = np.random.default_rng(0)      # probe_gather_scatter.py:40-77
    assert np.array_equal(table, rng.normal(size=(50_000, 512)).astype(
        np.float32))
    assert np.array_equal(ids, rng.integers(0, 50_000, (2048, 160)).astype(
        np.int32))
    assert np.array_equal(vals, rng.normal(size=(2048, 512)).astype(
        np.float32))
    assert np.array_equal(rid, rng.choice(50_000, 2048, replace=False)
                          .astype(np.int32))


_SMALL = dict(rows=300, dim=16, n=8, width=5, sn=32)
# probe_gather_scatter.py:55-65, and each port line's counterpart
_JAX_GATHERS = {
    "cast_then_gather": lambda t, i: t.astype(jnp.bfloat16)[i],
    "barrier_cast_then_gather": lambda t, i: jax.lax.optimization_barrier(
        t.astype(jnp.bfloat16))[i],
    "gather_then_cast": lambda t, i: t[i].astype(jnp.bfloat16),
    "gather_f32": lambda t, i: t[i],
    "gather_history f32 (current)": lambda t, i: t[i],
    "gather_history bf16": lambda t, i: t.astype(jnp.bfloat16)[i],
}


@pytest.mark.parametrize("name", list(gather.BUCKET_VARIANTS))
def test_bucket_gathers_equal_jax(name):
    assert set(_JAX_GATHERS) == set(gather.BUCKET_VARIANTS)
    table, ids, _, _ = gather.bucket_inputs(**_SMALL)
    bucket = gather.full_bucket(torch.from_numpy(ids))
    got = gather.BUCKET_VARIANTS[name](torch.from_numpy(table), bucket)
    want = _JAX_GATHERS[name](jnp.asarray(table), jnp.asarray(ids))
    assert got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))


# probe_gather_scatter.py:90-103
_JAX_SCATTERS = {
    "at_set_drop": lambda t, r, v: t.at[r].set(v, mode="drop"),
    "at_set_unique": lambda t, r, v: t.at[r].set(
        v, mode="drop", unique_indices=True),
    "at_set_unique_sorted": lambda t, r, v: t.at[r].set(
        v, mode="drop", unique_indices=True, indices_are_sorted=True),
    "dyn_update_slice": lambda t, r, v: jax.lax.dynamic_update_slice(
        t, v, (r[0], jnp.int32(0))),
}
_CLAMPED = np.int32(_SMALL["rows"] - 5) + np.arange(
    _SMALL["sn"], dtype=np.int32) % 5      # r[0] + sn > rows


@pytest.mark.parametrize("name, rid", [
    (name, "drawn") for name in gather.SCATTER_VARIANTS] + [
    (name, "clamped") for name, (_, kind, _) in gather.SCATTER_VARIANTS.items()
    if kind == "contiguous"])
def test_scatter_variants_equal_jax(name, rid):
    # each write-back leaves the table the script's expression leaves,
    # bit for bit; the contiguous forms clamp a window that would overrun
    # the table as dynamic_update_slice clamps it
    table, _, vals, drawn = gather.bucket_inputs(**_SMALL)
    rid = drawn if rid == "drawn" else _CLAMPED
    script, kind, fn = gather.SCATTER_VARIANTS[name]
    r = np.sort(rid) if kind != "random" else rid
    want = np.asarray(_JAX_SCATTERS[script](
        jnp.asarray(table), jnp.asarray(r), jnp.asarray(vals)))
    case = gather.scatter_case(rid, vals, table.shape[0], "cpu")
    got = torch.from_numpy(table.copy())
    fn(got, case)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gather.host_scatter(table, rid, vals, kind), want)


def test_window_start_clamps_as_dynamic_update_slice():
    assert gather.window_start(_CLAMPED, _SMALL["rows"]) == \
        _SMALL["rows"] - _SMALL["sn"]
    assert gather.window_start(np.array([7, 3, 9]), 100) == 3


# -- probe_eigh.py, probe_eigh2.py -------------------------------------

def _script_gram():
    """``probe_eigh.py:29-33`` and ``:60-62``: (float64 V, G as
    ``jnp.asarray`` makes it, the drifted G2)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(40000, 512)).astype(np.float32) / np.sqrt(512)
    v *= (1.0 / np.sqrt(np.arange(1, 512 + 1)))[None, :] * 3
    g = jnp.asarray(v.T @ v)
    g2 = g + jnp.asarray(0.01 * (v.T @ (v * rng.normal(
        size=(40000, 1)).astype(np.float32) * 0.05)))
    return v, g, 0.5 * (g2 + g2.T)


@pytest.fixture(scope="module")
def gram():
    return eigh.shared_inputs(), _script_gram()


def test_eigh_gramian_is_the_scripts_float32_cast(gram):
    # the script's V is float64 under NumPy 2's promotion, and jnp.asarray
    # rounds G to float32; the port rounds where it does
    (g, drift), (v, g_jax, g2_jax) = gram
    assert v.dtype == np.float64
    assert g_jax.dtype == jnp.float32 and g.dtype == np.float32
    assert np.array_equal(g, np.asarray(g_jax))
    g2 = eigh.drifted(torch.from_numpy(g), torch.from_numpy(drift))
    assert np.array_equal(g2.numpy(), np.asarray(g2_jax))


def _eigh_case(gram, which):
    if which == "shared 512":
        return gram[0][0]
    return next(g for b, d, g in eigh.sizes_inputs() if (b, d) == (8, 64))


@pytest.mark.parametrize("which", ["shared 512", "sizes [8, 64]"])
def test_eigh_reconstructs_as_jax(gram, which):
    g = _eigh_case(gram, which)
    w, q = torch.linalg.eigh(torch.from_numpy(g))
    err = eigh.reconstruction_error(w, q, torch.from_numpy(g))
    assert float(err.max()) <= eigh.RECON_TOL
    wj, qj = jnp.linalg.eigh(jnp.asarray(g))
    err_jax = jnp.linalg.norm(
        jnp.matmul(qj * wj[..., None, :], jnp.swapaxes(qj, -1, -2),
                   precision=HIGHEST) - g, axis=(-2, -1)) \
        / jnp.linalg.norm(g, axis=(-2, -1))
    assert float(jnp.max(err_jax)) <= eigh.RECON_TOL
    scale = np.abs(np.asarray(wj)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(w.numpy() - np.asarray(wj)) <= 1e-6 * scale)


@pytest.mark.parametrize("error_route, orth_route, error_f64, finite, ok", [
    (4e-8, 1e-6, 4e-8, True, True), (2e-5, 1e-6, 4e-8, True, False),
    (4e-8, 2e-4, 4e-8, True, False), (4e-8, 1e-6, 2e-5, True, False),
    (4e-8, 1e-6, 4e-8, False, False)])
def test_eigh_row_checks(error_route, orth_route, error_f64, finite, ok):
    # the port's route (woodbury.sym_eigh) and the float64 route to
    # RECON_TOL, the port's orthogonal to ORTH_TOL, and nothing that is
    # not finite; the raw float32 call (4.5e-4 here, the card's Jacobi at
    # 512) is a reading
    assert eigh.eigh_ok(dict(error=4.5e-4, orth=5e-3, error_f64=error_f64,
                             error_route=error_route, orth_route=orth_route,
                             finite=finite)) is ok


def test_orthogonality_reads_q_transpose_q():
    # ||Q^T Q - I||_F, the largest over a batch
    q = torch.linalg.qr(torch.randn(2, 16, 16, dtype=torch.float64)).Q
    assert eigh.orthogonality(q) < 1e-12
    q[1] = (1 + 1e-3) * torch.eye(16, dtype=torch.float64)
    assert eigh.orthogonality(q) == pytest.approx((2e-3 + 1e-6) * 4)


def test_eigh_drift_readings_equal_jax(gram):
    # probe_eigh.py:63-70 in G's own basis: the off-diagonal share and
    # the stale basis's error (sign-free, so either package's Q will do),
    # both ~1.4e-5; they agree to 1e-6, below the error of the bases they
    # rest on (each eigh reconstructs G to ~2.5e-6)
    (g, drift), (_, g_jax, g2_jax) = gram
    _, q = torch.linalg.eigh(torch.from_numpy(g))
    got = eigh.drift_readings(q, eigh.drifted(torch.from_numpy(g),
                                              torch.from_numpy(drift)))
    _, qj = jnp.linalg.eigh(g_jax)
    b = jnp.matmul(jnp.matmul(qj.T, g2_jax, precision=HIGHEST), qj,
                   precision=HIGHEST)
    off = b - jnp.diag(jnp.diag(b))
    recon = jnp.matmul(qj * jnp.diag(b), qj.T, precision=HIGHEST)
    want = {"offdiag_share": float(jnp.linalg.norm(off) / jnp.linalg.norm(b)),
            "stale_error": float(jnp.linalg.norm(recon - g2_jax)
                                 / jnp.linalg.norm(g2_jax))}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k


def test_newton_schulz_equals_jax():
    # probe_eigh.py:45-51 at d = 64, 30 iterations
    g, _ = eigh.shared_inputs(64, 4000)
    got = eigh.newton_schulz(torch.from_numpy(g)).numpy()

    def body(x, _):
        return 1.5 * x - 0.5 * jnp.einsum("ab,bc,cd->ad", x, x, x,
                                          precision=HIGHEST), None
    gj = jnp.asarray(g)
    want = np.asarray(jax.lax.scan(body, gj / jnp.linalg.norm(gj), None,
                                   length=eigh.NS_ITERS)[0])
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


@pytest.mark.parametrize("tol, branch", [(0.0, "cold"), (1.0, "warm")])
def test_refresh_reports_the_branch_it_took(tol, branch):
    g, drift = eigh.shared_inputs(256, 2000)
    g = torch.from_numpy(g)
    _, q = torch.linalg.eigh(g)
    taken, q2, lam = eigh.refresh(eigh.drifted(g, torch.from_numpy(drift)),
                                  q, tol)
    assert taken == branch
    assert q2.shape == (256, 256) and lam.shape == (256,)


def test_eigh_sizes_inputs_are_the_scripts():
    rng = np.random.default_rng(0)      # probe_eigh2.py:8, :29-34
    for batch, d, g in eigh.sizes_inputs():
        a = rng.normal(size=(batch, d, d)).astype(np.float32)
        want = np.einsum("nab,ncb->nac", a, a) / d
        assert g.dtype == np.float32
        assert np.array_equal(g, want if batch > 1 else want[0])


# -- probe_seqdot.py ---------------------------------------------------

def _jax_steps(name, precision, x, steps):
    """The script's scan bodies (``probe_seqdot.py:36-65``)."""
    bodies = {
        "seq x@x": lambda x: jnp.dot(x, x, precision=precision)
        * (0.999 / jnp.float32(1.0)),
        f"seq batched[{seqdot.BATCH}] x@x": lambda x: jnp.einsum(
            "nab,nbc->nac", x, x, precision=HIGHEST) * 0.999,
        f"{seqdot.INDEP} indep dots/iter": lambda x: sum(
            jnp.dot(x * (1.0 + 1e-6 * i), x, precision=HIGHEST)
            for i in range(8)) * (0.999 / 8),
    }
    out = []
    for _ in range(steps):
        x = bodies[name](x)
        out.append(np.asarray(x))
    return out


@pytest.mark.parametrize("v", seqdot.VARIANTS,
                         ids=lambda v: f"{v.name} {v.precision}")
def test_seqdot_steps_equal_jax(v):
    # d = 32; the port's "high" is TF32 on the card and float32 here, as
    # the script's DEFAULT is on the CPU
    draw = seqdot.draws((32,))[32]
    assert np.array_equal(draw, np.random.default_rng(0).normal(
        size=(32, 32)).astype(np.float32))
    x0 = seqdot.start(draw, "cpu")
    precision = (HIGHEST if v.precision == "highest"
                 else jax.lax.Precision.DEFAULT)
    xj = jnp.asarray(draw) * 0.001
    assert np.array_equal(x0.numpy(), np.asarray(xj))
    if v.batch > 1:
        xj = jnp.stack([xj] * v.batch)
    want = _jax_steps(v.name, precision, xj, seqdot.CHECK_STEPS)
    with matmul_precision("highest"):
        got = seqdot.chain(v.step, seqdot.initial(v, x0), seqdot.CHECK_STEPS)
    for g, w in zip(got, want):
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


@pytest.mark.parametrize("d", seqdot.DS)
def test_seqdot_chain_underflows_by_step_five(d):
    # the script's input reaches exact zeros within five steps, so only
    # the first three products carry a check
    x0 = seqdot.start(seqdot.draws()[d], "cpu")
    with matmul_precision("highest"):
        xs = seqdot.chain(seqdot.seq_step, x0, 5)
    assert bool((xs[2] != 0).any()) and bool((xs[4] == 0).all())


def _fake_tree(root, eigh_ms):
    """A tree whose ``epoch_profile`` prints the two ``[classes]`` lines
    that ``probes/epoch_ab.py`` reads, with its tree's name."""
    probes_dir = root / "safer2_recommender_tpu_torch" / "probes"
    probes_dir.mkdir(parents=True)
    for d in (probes_dir.parent, probes_dir):
        (d / "__init__.py").write_text("")
    (probes_dir / "epoch_profile.py").write_text(
        "import sys\n"
        "w = sys.argv[2]\n"
        f"print(f'[classes {{w}}] device kernel time 100.5 ms/epoch over 2"
        f" epochs')\n"
        f"print(f'[classes {{w}}]   eigh      {eigh_ms} ms/epoch   9.9%')\n")
    return str(root)


def test_epoch_ab_runs_each_tree_in_turn_and_reads_the_eigh_class(
        tmp_path, capsys):
    from safer2_recommender_tpu_torch.probes import epoch_ab

    parent = _fake_tree(tmp_path / "parent", 16.5)
    change = _fake_tree(tmp_path / "change", 9.5)
    out = tmp_path / "out"
    assert epoch_ab.main([parent, change, "--workloads", "synth50k",
                          "--out", str(out)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[epoch-ab]")]
    assert [ln.split(":")[0] for ln in lines] == [
        f"[epoch-ab] synth50k run {k} {side}"
        for k, side in enumerate(epoch_ab.ORDER, 1)]
    assert [("16.5" in ln, "9.5" in ln) for ln in lines] == [
        (True, False), (False, True), (False, True), (True, False)]
    assert all("all kernels 100.5 ms" in ln for ln in lines)
    assert sorted(os.listdir(out)) == sorted(
        f"{k}_{side}_synth50k.out" for k, side in enumerate(epoch_ab.ORDER, 1))
    # a tree whose profile prints no eigh row makes the exit code 1
    (tmp_path / "change" / "safer2_recommender_tpu_torch" / "probes"
     / "epoch_profile.py").write_text("print('nothing')\n")
    assert epoch_ab.main([parent, change, "--workloads", "synth50k",
                          "--out", str(out)]) == 1
