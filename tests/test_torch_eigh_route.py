"""The port's one eigendecomposition, ``ops/woodbury.py::sym_eigh``,
against the JAX package's ``maybe_eigh``, ``refresh_eigh`` and the ++
models' block eigh, at every shape the epochs give it
(``probes/eigh.py::ROUTE_SHAPES``), on the CPU; the same bounds on the
card (``cuda``-marked). Reconstructions are compared, not eigenvectors
(clustered directions may rotate freely): ||Q diag(lam) Q^T - G||_F /
||G||_F <= 1e-5 (the JAX package's bound on a cold eigh) and
||Q^T Q - I||_F <= 1e-4, float32 outputs, ascending eigenvalues. And no
module of the port outside ``probes/`` calls ``torch.linalg.eigh`` but
through it."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from safer2_recommender_tpu.ops import woodbury as jwb
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import woodbury as twb
from safer2_recommender_tpu_torch.probes import eigh

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "safer2_recommender_tpu_torch")
SHAPES = {f"{b}x{d}": (b, d, g) for b, d, g in eigh.route_inputs()}


def _recon(lam, q):
    q = np.asarray(q, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    return (q * lam[..., None, :]) @ np.swapaxes(q, -1, -2)


def _rel(a, g):
    g = np.asarray(g, dtype=np.float64)
    return (np.linalg.norm(a - g, axis=(-2, -1))
            / np.linalg.norm(g, axis=(-2, -1)))


def _orth(q):
    q = np.asarray(q, dtype=np.float64)
    eye = np.eye(q.shape[-1])
    return np.linalg.norm(np.swapaxes(q, -1, -2) @ q - eye, axis=(-2, -1))


def _check_route(lam, q, g):
    assert lam.dtype == torch.float32 and q.dtype == torch.float32
    lam_n, q_n = lam.cpu().numpy(), q.cpu().numpy()
    assert np.all(np.diff(lam_n, axis=-1) >= 0)
    assert np.all(_rel(_recon(lam_n, q_n), g) <= eigh.RECON_TOL)
    assert np.all(_orth(q_n) <= eigh.ORTH_TOL)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_sym_eigh_meets_the_bounds_and_reconstructs_as_jax(shape):
    # the same Gramians through the JAX package's eigh (what its
    # maybe_eigh, refresh_eigh and block sweep call): both reconstruct
    # within 1e-5, so within 2e-5 of each other, and their eigenvalues
    # agree to f32 rounding
    _, d, g = SHAPES[shape]
    lam, q = twb.sym_eigh(torch.from_numpy(g))
    _check_route(lam, q, g)
    lj, qj = jnp.linalg.eigh(jnp.asarray(g))
    rj = _recon(np.asarray(lj), np.asarray(qj))
    assert np.all(_rel(rj, g) <= eigh.RECON_TOL)
    assert np.all(_rel(_recon(lam.numpy(), q.numpy()), rj) <= 2e-5)
    scale = np.abs(np.asarray(lj)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(lam.numpy() - np.asarray(lj)) <= 1e-5 * scale)


@pytest.fixture()
def counted(monkeypatch):
    """Calls of ``woodbury.sym_eigh`` by input shape."""
    calls = []
    real = twb.sym_eigh

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(twb, "sym_eigh", spy)
    return calls


@pytest.mark.parametrize("d", [128, 256, 512])
def test_maybe_eigh_is_sym_eigh_and_matches_jax(counted, d):
    g = SHAPES[f"1x{d}"][2]
    q, lam = twb.maybe_eigh(torch.from_numpy(g), d, use_cg=False)
    assert counted == [(d, d)]
    _check_route(lam, q, g)
    qj, lj = jwb.maybe_eigh(jnp.asarray(g), d, use_cg=False)
    assert np.all(_rel(_recon(lam.numpy(), q.numpy()),
                       _recon(np.asarray(lj), np.asarray(qj))) <= 2e-5)


@pytest.mark.parametrize("d", [256, 512])
def test_refresh_eigh_both_branches_are_sym_eigh_and_match_jax(counted, d):
    # warm (tol 1): the [d / 128, 128, 128] diagonal blocks of the
    # rotated Gramian; cold (tol 0): the whole Gramian. The JAX
    # package's refresh_eigh from the same previous basis gives the same
    # reconstruction (the warm one drops the same off-block coupling)
    g = SHAPES[f"1x{d}"][2]
    rng = np.random.default_rng(d)
    q_prev = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    k = d // 128
    for tol, calls, exact in ((1.0, [(k, 128, 128)], False),
                              (0.0, [(d, d)], True)):
        counted.clear()
        q, lam = twb.refresh_eigh(torch.from_numpy(g),
                                  torch.from_numpy(q_prev), tol)
        assert counted == calls
        qj, lj = jwb.refresh_eigh(jnp.asarray(g), jnp.asarray(q_prev), tol)
        rt = _recon(lam.numpy(), q.numpy())
        assert _rel(rt, _recon(np.asarray(lj), np.asarray(qj))) <= 2e-5
        assert _orth(q.numpy()) <= eigh.ORTH_TOL
        if exact:
            _check_route(lam, q, g)


@pytest.mark.parametrize("dim, bs", [(512, 64), (512, 32), (64, 32)])
def test_block_eigh_is_sym_eigh_and_matches_jax(counted, dim, bs):
    # the ++ models' [dim / bs, bs, bs] diagonal blocks, as the JAX
    # package's block sweep takes them (models/common.py:568-572)
    g = SHAPES["1x512"][2][:dim, :dim]
    lam, q = common.block_eigh(torch.from_numpy(g), bs)
    nb = dim // bs
    assert counted == [(nb, bs, bs)]
    gj = jnp.asarray(g)
    diag = gj.reshape(nb, bs, nb, bs)[jnp.arange(nb), :, jnp.arange(nb), :]
    lj, qj = jnp.linalg.eigh(diag)
    blocks = np.asarray(diag)
    assert lam.dtype == torch.float32 and float(lam.min()) >= 0.0
    assert np.all(_rel(_recon(lam.numpy(), q.numpy()), blocks)
                  <= eigh.RECON_TOL)
    assert np.all(_orth(q.numpy()) <= eigh.ORTH_TOL)
    assert np.all(_rel(_recon(lam.numpy(), q.numpy()),
                       _recon(np.maximum(np.asarray(lj), 0), np.asarray(qj)))
                  <= 2e-5)


def _eigh_calls(path):
    """(function name, line) of every ``linalg.eigh`` the module at
    ``path`` calls or imports, by its source."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if (isinstance(child, ast.Attribute) and child.attr in
                    ("eigh", "eigh_") and isinstance(child.value, ast.Attribute)
                    and child.value.attr == "linalg"):
                found.append((fn, child.lineno))
            if isinstance(child, ast.ImportFrom) and child.module and \
                    "linalg" in child.module and any(
                        a.name == "eigh" for a in child.names):
                found.append((fn, child.lineno))
            visit(child, name)

    visit(tree, None)
    return found


def test_no_module_outside_probes_calls_eigh_but_through_sym_eigh():
    seen = {}
    for root, _, files in os.walk(PKG):
        if os.path.basename(root) == "probes":
            continue
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                calls = _eigh_calls(path)
                if calls:
                    seen[os.path.relpath(path, PKG)] = calls
    assert list(seen) == [os.path.join("ops", "woodbury.py")], seen
    assert {fn for fn, _ in seen[os.path.join("ops", "woodbury.py")]} == \
        {"sym_eigh"}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sym_eigh_meets_the_bounds_on_cuda(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the route to hold is cuSOLVER's")
    _, _, g = SHAPES[shape]
    lam, q = twb.sym_eigh(torch.from_numpy(g).cuda())
    assert lam.is_cuda and q.is_cuda
    _check_route(lam, q, g)


@pytest.mark.parametrize("name", list(eigh.CANDIDATES))
def test_candidate_routes_decompose_on_the_cpu(name):
    # the probe's candidates (float32, float64, padded syevd, float32 +
    # Rayleigh-Ritz) each give an eigendecomposition of the input, to
    # the CPU's LAPACK accuracy
    for shape in ("4x128", "1x256"):
        g = SHAPES[shape][2]
        lam, q = eigh.CANDIDATES[name](torch.from_numpy(g))
        assert lam.shape == g.shape[:-1] and q.shape == g.shape
        assert np.all(_rel(_recon(lam.numpy(), q.numpy()), g) <= 1e-5)
        assert np.all(np.diff(lam.numpy(), axis=-1) >= 0)


def test_route_ok_holds_the_ports_route():
    good = dict(finite=True, ascending=True, error=1e-7, orth=1e-6)
    assert eigh.route_ok(dict(route=good))
    for key, bad in (("error", 2e-5), ("orth", 2e-4), ("finite", False),
                     ("ascending", False)):
        assert not eigh.route_ok(dict(route=dict(good, **{key: bad})))
