"""Float64 oracles of one training epoch of each model, and their check
of the port's epochs on the GPU.

    python -m safer2_recommender_tpu_torch.probes.oracle [--dims 8 128 512]

The oracles are the port's copy of the JAX package's
``tests/test_numpy_oracle.py``: each re-derives an epoch row by row with
plain numpy linear algebra in float64, straight from the reference's
math (``ials.h:88-144, 187-224``, ``safer2.h:104-221, 266-334``,
``erm_mf.h:91-210``, ``cvar_mf.h:88-134, 282-295, 582-595``,
``ialspp.h:85-145, 208-261``, ``safer2pp.h:97-216, 303-319``). Nothing is
shared with the port but ``Config``. Each takes the dataset's pairs (an
``Adjacency``), the ``Config`` and the float64 tables at the top of the
epoch, and returns the float64 tables after it (with the per-user loss,
dual weight and xi where the model keeps them). The SAFER family's
oracles hold xi at its warm start (``xi_iterations=0``, one pd
iteration), as the JAX package's do: the Newton-Raphson machinery has
tests of its own.

The frozen-order ++ oracles follow one routing choice of the port (and
of the JAX package): a row whose bucket is at most dim / 2 wide, where
the full-dim eigenbasis is on (dim >= 128), is solved by one exact
full-dim solve, which the block delta sweep converges to; ``exact_users``
/ ``exact_items`` name those rows.

``run`` (CUDA only) trains each model on the card through the normal
entry points (``get_model``, ``DeviceData.build``), exports the initial
tables, runs the epochs and holds each epoch's tables to the oracle run
from the same float64 start, within the oracles' own bounds (rtol 2e-4,
atol 2e-5 x max(1, dim / 8), ``tests/test_numpy_oracle.py:77-79``). At
dims 8 and 128 the data is the oracle tests' (2,500 draws over 90 users
x 40 items, seed 42); at 512 a power-law set of ``POWER_USERS`` x
``POWER_ITEMS`` whose rows take every solve route of
``woodbury.SOLVE_PATHS`` the model's epoch has, the wide one through a
lowered ``assemble.WIDE_SLAB_BYTES`` (as the CPU tests reach it). At 512
each model runs twice from the same initial tables: with the port's
``woodbury.sym_eigh``, and with the raw float32 ``torch.linalg.eigh`` in
its place (patched in this process only). The oracle's bound cannot
see that float32 basis at 512, so there every epoch is also held to a
max abs error of ``SHARP_ABS_512``, and the raw float32 run is its
control: where the epoch decomposes the full-dim Gramian, it must exceed
that limit. SAFER2, iALS and iALS++ run two epochs at 512 (the second
starts from a carried eigenbasis; at the default ``eig_refresh_tol``, 0,
it takes a full eigh, and no epoch may take the warm refresh), CVaR-MF
two everywhere (the first keeps xi at 0); at ``WARM_DIM`` (256) the
three run two epochs on the small set at the default, held like every
other epoch, and again at the JAX package's tolerance
(``config.JAX_EIG_REFRESH_TOL``, 0.08), whose second epoch takes the
warm refresh: those second epochs are readings, printed beside the
held ones.
The frozen ++ models also run at dim 64, block 32, the one dim of these
whose epochs take the block-level Woodbury (``block_woodbury``: the
full-dim eigenbasis supersedes it from dim 128).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from math import erf, sqrt
from typing import Dict, List, Optional, Sequence

import numpy as np

from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL, Config

RTOL = 2e-4
DIMS = (8, 128, 512)
POWER_USERS, POWER_ITEMS, POWER_SEED = 1000, 600, 2
# dim -> block size of the ++ models
BLOCK = {8: 4, 64: 32, 128: 32, 256: 64, 512: 64}


def atol(dim: int) -> float:
    """The oracles' absolute bound: f32 error grows with the
    accumulation length (dim)."""
    return 2e-5 * max(1, dim / 8)


# --------------------------------------------------------------------------
# the oracles
# --------------------------------------------------------------------------


class Adjacency:
    """The dataset's pairs as per-row histories (original ids), with the
    statistics the SAFER family's regularizers read."""

    def __init__(self, user_ids, item_ids, num_users: int, num_items: int):
        self.num_users, self.num_items = num_users, num_items
        by_u: Dict[int, List[int]] = {}
        by_i: Dict[int, List[int]] = {}
        for u, i in zip(np.asarray(user_ids), np.asarray(item_ids)):
            by_u.setdefault(int(u), []).append(int(i))
            by_i.setdefault(int(i), []).append(int(u))
        self.by_u = {k: np.array(v) for k, v in by_u.items()}
        self.by_i = {k: np.array(v) for k, v in by_i.items()}
        self.hist_size = np.zeros(num_users)
        for u, hist in self.by_u.items():
            self.hist_size[u] = len(hist)
        self.present = self.hist_size > 0
        # sum over an item's users of 1/|H_u| (safer2.h item regularizer)
        self.item_stat = np.zeros(num_items)
        for i, users in self.by_i.items():
            self.item_stat[i] = np.sum(1.0 / self.hist_size[users])


def losses(adj: Adjacency, cfg: Config, u: np.ndarray, v: np.ndarray, *,
           halve: bool) -> np.ndarray:
    """Per-user loss mean_h (v^T u - 1)^2 + uobs u^T G u [/ 2]
    (ials.h:70-86, safer2.h:85-101); absent users 0."""
    g = v.T @ v
    out = np.zeros(adj.num_users)
    for r, hist in adj.by_u.items():
        p = v[hist] @ u[r]
        out[r] = np.mean((p - 1.0) ** 2) + cfg.uobs_weight * u[r] @ g @ u[r]
    return 0.5 * out if halve else out


def gaussian_dual(cfg: Config, loss: np.ndarray, xi: float) -> np.ndarray:
    """The z-step 1 - K_cdf(-(loss - xi) / h), gaussian kernel
    (safer2.h:745-794), at every id."""
    return np.array([1.0 - 0.5 * (1.0 + erf(-(x - xi) / cfg.bandwidth
                                            / sqrt(2.0))) for x in loss])


def _ials_reg(cfg: Config, n_hist: int, n_choices: int) -> float:
    """reg * (|H| + uobs * n)^exp (ials.h:310-315)."""
    return cfg.l2_reg * (n_hist + cfg.uobs_weight * n_choices) \
        ** cfg.l2_reg_exp


def _exact(vh, g, ch, cg, reg) -> np.ndarray:
    """argmin of the row's system: A = sum_h ch v v^T + cg G + reg I,
    rhs = sum_h ch v (``ch`` a scalar or one weight per slot)."""
    wv = vh * (ch if np.ndim(ch) == 0 else ch[:, None])
    a = wv.T @ vh
    a += cg * g
    a[np.diag_indices(a.shape[0])] += reg
    return np.linalg.solve(a, wv.sum(0))


def _block_step(x, vh, g, s: slice, ch, cg, reg) -> np.ndarray:
    """One block delta solve (ialspp.h:85-145, safer2pp.h:97-159):
    A = sum_h ch v_loc v_loc^T + cg G_loc + reg I,
    rhs = sum_h ch v_loc (pred - 1) + cg G_lg x + reg x_loc,
    x_loc <- x_loc - A^-1 rhs."""
    pred = vh @ x
    vloc = vh[:, s]
    wv = vloc * (ch if np.ndim(ch) == 0 else ch[:, None])
    a = wv.T @ vloc + cg * g[s, s] + reg * np.eye(s.stop - s.start)
    rhs = wv.T @ (pred - 1.0) + cg * (g[s, :] @ x) + reg * x[s]
    out = x.copy()
    out[s] = x[s] - np.linalg.solve(a, rhs)
    return out


def _blocks(dim: int, bs: int) -> List[slice]:
    return [slice(k, min(k + bs, dim)) for k in range(0, dim, bs)]


def _rows(table, hists, fn):
    """A copy of ``table`` with each row ``r`` of ``hists`` set to
    ``fn(r, hist)``."""
    out = table.copy()
    for r, hist in hists.items():
        out[r] = fn(r, hist)
    return out


def _sweep(table, other, hists, g, coef, *, blocks=None, exact=None):
    """One side against the frozen ``other``: each row's exact solve, or
    (``blocks``) its block delta steps in order, but the rows ``exact``
    marks. ``coef(row, hist) -> (ch, cg, reg)``."""
    def one(r, hist):
        ch, cg, reg = coef(r, hist)
        if blocks is None or (exact is not None and exact[r]):
            return _exact(other[hist], g, ch, cg, reg)
        x = table[r]
        for s in blocks:
            x = _block_step(x, other[hist], g, s, ch, cg, reg)
        return x

    return _rows(table, hists, one)


def _block_pass(table, other, hists, g, coef, s: slice):
    """One block ``s`` of every row against ``other`` (the interleaved
    order's StepU / StepV)."""
    return _rows(table, hists, lambda r, hist: _block_step(
        table[r], other[hist], g, s, *coef(r, hist)))


def _ials_coefs(adj: Adjacency, cfg: Config):
    nu, ni = adj.num_users, adj.num_items
    return ((lambda r, h: (1.0, cfg.uobs_weight, _ials_reg(cfg, len(h), ni))),
            (lambda r, h: (1.0, cfg.uobs_weight, _ials_reg(cfg, len(h), nu))))


def _safer_coefs(adj: Adjacency, cfg: Config, dual: np.ndarray):
    """The SAFER family's user system (w (sum v v^T / |H| + uobs G) +
    reg I) and item system (uobs G_w + sum z/|H_u| u u^T + reg I)."""
    u_reg = cfg.l2_reg * (1.0 + cfg.uobs_weight * adj.num_items)
    item_reg = cfg.l2_reg * (adj.item_stat
                             + cfg.alpha * cfg.uobs_weight * adj.num_users)
    norm = np.where(adj.present, dual / np.maximum(adj.hist_size, 1.0), 0.0)
    return ((lambda r, h: (dual[r] / len(h), cfg.uobs_weight * dual[r],
                           u_reg)),
            (lambda r, h: (norm[h], cfg.uobs_weight, item_reg[r])))


def _need_warm_xi(cfg: Config) -> None:
    if cfg.xi_iterations != 0 or cfg.pd_iterations != 1:
        raise ValueError("the SAFER oracles hold xi at its warm start: "
                         "xi_iterations=0, pd_iterations=1")


def _safer_start(adj, cfg, u, v, xi, dual, steps, every_id=False):
    """(pre-epoch loss, xi, dual) of a SAFER epoch: xi warm-starts at the
    mean loss on the first epoch (safer2.h:819-838), carried after; the
    present users' dual weights from the z-step, the rest carried
    (SAFER2++ steps every id, safer2pp.h:839-862)."""
    _need_warm_xi(cfg)
    loss = losses(adj, cfg, u, v, halve=True)
    xi = float(loss.mean()) if steps == 0 else xi
    dual = np.full(adj.num_users, cfg.alpha) if dual is None else dual
    dual = np.where(adj.present | every_id, gaussian_dual(cfg, loss, xi),
                    dual)
    return loss, xi, dual


def ials(adj: Adjacency, cfg: Config, u, v) -> dict:
    """iALS (ials.h:317-365): exact solves of U against V, then of V
    against the new U; the stored loss is the pre-epoch model's, not
    halved."""
    cu, ci = _ials_coefs(adj, cfg)
    u1 = _sweep(u, v, adj.by_u, v.T @ v, cu)
    v1 = _sweep(v, u1, adj.by_i, u1.T @ u1, ci)
    return dict(user_emb=u1, item_emb=v1,
                user_loss=losses(adj, cfg, u, v, halve=False))


def safer2(adj: Adjacency, cfg: Config, u, v, *, xi: float = 0.0,
           dual=None, steps: int = 0) -> dict:
    """SAFER2 (safer2.h:104-221): z-step, U against V, V against the new
    U and its dual-weighted Gramian."""
    loss, xi, dual = _safer_start(adj, cfg, u, v, xi, dual, steps)
    cu, ci = _safer_coefs(adj, cfg, dual)
    u1 = _sweep(u, v, adj.by_u, v.T @ v, cu)
    v1 = _sweep(v, u1, adj.by_i, u1.T @ (u1 * dual[:, None]), ci)
    return dict(user_emb=u1, item_emb=v1, dual_weight=dual, xi=xi,
                user_loss=loss)


def erm_mf(adj: Adjacency, cfg: Config, u, v) -> dict:
    """ERM-MF (erm_mf.h:91-210): SAFER2's systems with z = alpha for
    every user."""
    dual = np.full(adj.num_users, cfg.alpha)
    cu, ci = _safer_coefs(adj, cfg, dual)
    u1 = _sweep(u, v, adj.by_u, v.T @ v, cu)
    v1 = _sweep(v, u1, adj.by_i, cfg.alpha * (u1.T @ u1), ci)
    return dict(user_emb=u1, item_emb=v1, dual_weight=dual,
                user_loss=losses(adj, cfg, u, v, halve=True))


def _grad_step(table, other, hists, g, coef, eta: float):
    """x <- x - eta (A x - rhs) per row (cvar_mf.h:88-134)."""
    out = table.copy()
    for r, hist in hists.items():
        ch, cg, reg = coef(r, hist)
        vh, x = other[hist], table[r]
        wv = vh * (ch if np.ndim(ch) == 0 else ch[:, None])
        ax = wv.T @ (vh @ x) + cg * (g @ x) + reg * x
        out[r] = x - eta * (ax - wv.sum(0))
    return out


def cvar_mf(adj: Adjacency, cfg: Config, u, v, *, xi: float = 0.0,
            dual=None, steps: int = 0) -> dict:
    """CVaR-MF: from the second epoch xi is the floor(n alpha)-th largest
    loss over every id (cvar_mf.h:582-595); the hard indicator z, then
    gradient steps of U and of V, V against the PRE-update U
    (cvar_mf.h:282-295)."""
    nu = adj.num_users
    loss = losses(adj, cfg, u, v, halve=True)
    if steps > 0:
        q = min(int(nu * cfg.alpha), nu - 1)
        xi = float(np.sort(loss)[nu - 1 - q])
    dual = np.full(nu, cfg.alpha) if dual is None else dual
    dual = np.where(adj.present, (loss - xi >= 0.0).astype(float), dual)
    cu, ci = _safer_coefs(adj, cfg, dual)
    u1 = _grad_step(u, v, adj.by_u, v.T @ v, cu, cfg.stepsize)
    v1 = _grad_step(v, u, adj.by_i, u.T @ (u * dual[:, None]), ci,
                    cfg.stepsize)
    return dict(user_emb=u1, item_emb=v1, dual_weight=dual, xi=xi,
                user_loss=loss)


def ialspp(adj: Adjacency, cfg: Config, u, v, *, exact_users=None,
           exact_items=None) -> dict:
    """iALS++ in the frozen order: every U block against the frozen V,
    then every V block against the new U (ialspp.h:85-145); the stored
    loss is the pre-epoch model's, not halved."""
    cu, ci = _ials_coefs(adj, cfg)
    blocks = _blocks(cfg.dim, cfg.block_size)
    u1 = _sweep(u, v, adj.by_u, v.T @ v, cu, blocks=blocks,
                exact=exact_users)
    v1 = _sweep(v, u1, adj.by_i, u1.T @ u1, ci, blocks=blocks,
                exact=exact_items)
    return dict(user_emb=u1, item_emb=v1,
                user_loss=losses(adj, cfg, u, v, halve=False))


def ialspp_interleaved(adj: Adjacency, cfg: Config, u, v) -> dict:
    """iALS++ in the reference's order: per block, StepU against the
    live V, then StepV against the live U (ialspp.h:208-261, :362-365);
    the stored loss is the end-of-epoch model's, not halved."""
    cu, ci = _ials_coefs(adj, cfg)
    for s in _blocks(cfg.dim, cfg.block_size):
        u = _block_pass(u, v, adj.by_u, v.T @ v, cu, s)
        v = _block_pass(v, u, adj.by_i, u.T @ u, ci, s)
    return dict(user_emb=u, item_emb=v,
                user_loss=losses(adj, cfg, u, v, halve=False))


def safer2pp(adj: Adjacency, cfg: Config, u, v, *, xi: float = 0.0,
             dual=None, steps: int = 0, exact_users=None,
             exact_items=None) -> dict:
    """SAFER2++ in the frozen order: user blocks (safer2pp.h:97-159),
    then item blocks against the dual-weighted Gramian with z/|H_u| slot
    weights (safer2pp.h:161-216); the stored loss is the pre-epoch
    model's."""
    loss, xi, dual = _safer_start(adj, cfg, u, v, xi, dual, steps, True)
    cu, ci = _safer_coefs(adj, cfg, dual)
    blocks = _blocks(cfg.dim, cfg.block_size)
    u1 = _sweep(u, v, adj.by_u, v.T @ v, cu, blocks=blocks,
                exact=exact_users)
    v1 = _sweep(v, u1, adj.by_i, u1.T @ (u1 * dual[:, None]), ci,
                blocks=blocks, exact=exact_items)
    return dict(user_emb=u1, item_emb=v1, dual_weight=dual, xi=xi,
                user_loss=loss)


def safer2pp_interleaved(adj: Adjacency, cfg: Config, u, v, *,
                         xi: float = 0.0, dual=None, steps: int = 0) -> dict:
    """SAFER2++ in the reference's order (safer2pp.h:303-319): per
    block, the user step against the live V^T V, then the item step
    against the live U^T diag(z) U; the stored loss is the end-of-epoch
    model's (from the carried predictions, safer2pp.h:611-652)."""
    _, xi, dual = _safer_start(adj, cfg, u, v, xi, dual, steps, True)
    cu, ci = _safer_coefs(adj, cfg, dual)
    for s in _blocks(cfg.dim, cfg.block_size):
        u = _block_pass(u, v, adj.by_u, v.T @ v, cu, s)
        v = _block_pass(v, u, adj.by_i, u.T @ (u * dual[:, None]), ci, s)
    return dict(user_emb=u, item_emb=v, dual_weight=dual, xi=xi,
                user_loss=losses(adj, cfg, u, v, halve=True))


# --------------------------------------------------------------------------
# the models' cases
# --------------------------------------------------------------------------

SAFER_CFG = dict(uobs_weight=0.004, l2_reg=0.004, alpha=0.3, bandwidth=0.15,
                 xi_iterations=0, pd_iterations=1)
IALS_CFG = dict(uobs_weight=0.1, l2_reg=0.003, l2_reg_exp=1.0, stdev=0.1)


@dataclasses.dataclass(frozen=True)
class Case:
    """One model and order: the port's model name, its Config fields
    (the oracle tests'), the oracle, whether it carries the SAFER state
    (xi, dual, steps), whether the frozen ++ routing applies, and the
    solve routes its epoch takes at dim 512."""

    model: str
    cfg: dict
    oracle: object
    carries: bool = False
    frozen_pp: bool = False
    routes: tuple = ()


EXACT_ROUTES = ("woodbury", "rotated", "direct", "wide")
FROZEN_PP_ROUTES = ("woodbury", "block", "wide")
CASES = {
    "ials": Case("ials", IALS_CFG, ials, routes=EXACT_ROUTES),
    "safer2": Case("safer2", SAFER_CFG, safer2, carries=True,
                   routes=EXACT_ROUTES),
    "erm_mf": Case("erm_mf", dict(uobs_weight=0.004, l2_reg=0.004,
                                  alpha=0.3), erm_mf, routes=EXACT_ROUTES),
    "cvar_mf": Case("cvar_mf", dict(uobs_weight=0.004, l2_reg=0.004,
                                    alpha=0.3, stepsize=0.1), cvar_mf,
                    carries=True, routes=("wide",)),
    "ialspp": Case("ialspp", IALS_CFG, ialspp, frozen_pp=True,
                   routes=FROZEN_PP_ROUTES),
    "ialspp-interleaved": Case("ialspp", dict(IALS_CFG,
                                              block_interleaved=True),
                               ialspp_interleaved, routes=("block", "wide")),
    "safer2pp": Case("safer2pp", SAFER_CFG, safer2pp, carries=True,
                     frozen_pp=True, routes=FROZEN_PP_ROUTES),
    "safer2pp-interleaved": Case("safer2pp", dict(SAFER_CFG,
                                                  block_interleaved=True),
                                 safer2pp_interleaved, carries=True,
                                 routes=("block", "wide")),
}
# the block-level Woodbury: the frozen ++ epochs at dim 64, block 32
BLOCK_WOODBURY_DIM = 64
# the models whose second epoch refreshes a carried eigenbasis
CARRIED_BASIS = ("safer2", "ials", "ialspp")
# At the port's default ``eig_refresh_tol`` (0) every eigenbasis is a
# full eigh, and every epoch is held to the bound, the second epochs at
# WARM_DIM (256, the small set) of these three included; none may take
# the warm refresh. At the JAX package's 0.08 the warm refresh
# (``woodbury.refresh_eigh``) drops up to 8% of the rotated Gramian's
# norm, an approximation of the exact epoch in the JAX package too: the
# same second epochs at 0.08 must take it and are readings, not held
# (the first epoch, from the identity basis, is held).
WARM_DIM = 256
# At dim 512 the oracle's bound (atol 1.28e-3) cannot see a float32
# Jacobi basis, so every epoch there is also held to this max abs error,
# set between the two routes' readings on an H100 (the port's <=
# 6.44e-06, the raw float32 eigh's >= 3.56e-05; PERF.md section 6). The
# raw float32 run of a model whose epoch decomposes the full-dim
# Gramian is its control: it must exceed the limit.
SHARP_ABS_512 = 1.5e-5


def epochs_of(key: str, dim: int) -> int:
    """Two where the second epoch refreshes a carried eigenbasis (SAFER2,
    iALS, iALS++ at 256 and 512) and for CVaR-MF (its first keeps xi at
    0)."""
    return 2 if key == "cvar_mf" or (dim >= WARM_DIM
                                     and key in CARRIED_BASIS) else 1


def cases(dims: Sequence[int] = DIMS) -> List[tuple]:
    """(key, dim) of every run at the default ``Config``, or (key, dim,
    eig_refresh_tol): each case at each dim, and when 512 is run, the
    frozen ++ models at ``BLOCK_WOODBURY_DIM`` and ``CARRIED_BASIS`` at
    ``WARM_DIM``, each at the default and then at the JAX package's
    tolerance (the warm refresh's readings)."""
    out = [(key, dim) for dim in dims for key in CASES]
    if 512 in dims:
        out += [(key, BLOCK_WOODBURY_DIM) for key in ("ialspp", "safer2pp")]
        for key in CARRIED_BASIS:
            out += [(key, WARM_DIM), (key, WARM_DIM, JAX_EIG_REFRESH_TOL)]
    return out


def small_pairs() -> np.ndarray:
    """``tests/test_numpy_oracle.py::small``: 2,500 draws over 90 users x
    40 items, seed 42, deduplicated."""
    rng = np.random.default_rng(42)
    return np.unique(np.stack([rng.integers(0, 90, 2500),
                               rng.integers(0, 40, 2500)], 1),
                     axis=0).astype(np.int32)


def power_pairs() -> np.ndarray:
    """A power-law set (``data/synth.py::powerlaw_dataset``) of
    ``POWER_USERS`` x ``POWER_ITEMS``, deduplicated: user histories
    past 256 (the rotated route at dim 512) and a head item past 512
    users (a width-1,024 bucket: wide, and the direct batch it joins)."""
    from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset

    u, i = powerlaw_dataset(POWER_USERS, POWER_ITEMS, mean_hist=80,
                            seed=POWER_SEED)
    return np.unique(np.stack([u, i], 1), axis=0).astype(np.int32)


def pairs_for(dim: int) -> np.ndarray:
    return small_pairs() if dim <= WARM_DIM else power_pairs()


def config(key: str, dim: int, tol: Optional[float] = None) -> Config:
    """The case's config at ``dim``; ``tol`` sets ``eig_refresh_tol``
    (None: the default)."""
    cfg = Config(dim=dim, block_size=BLOCK[dim], compute_dtype="f32",
                 seed=5, **CASES[key].cfg)
    return cfg if tol is None else cfg.replace(eig_refresh_tol=tol)


def exact_rows(buckets, perm, n: int, dim: int) -> np.ndarray:
    """Which original ids sit in a bucket of width <= dim / 2 (the frozen
    ++ models solve those exactly where the full-dim eigenbasis is on,
    dim >= 128)."""
    width = np.zeros(n, dtype=np.int64)
    for b in buckets:
        ids = b.row_ids.cpu().numpy()
        width[ids[ids < n]] = b.width
    return (dim >= 128) & (2 * width[np.asarray(perm.cpu())] <= dim)


def step_oracle(case: Case, adj: Adjacency, cfg: Config, start: dict,
                steps: int, exact=None) -> dict:
    """The oracle's epoch from ``start`` (float64 tables; xi and dual
    carried for the SAFER family)."""
    kw = {}
    if case.carries:
        kw = dict(xi=start.get("xi", 0.0), dual=start.get("dual_weight"),
                  steps=steps)
    if case.frozen_pp and exact is not None:
        kw.update(exact_users=exact[0], exact_items=exact[1])
    return case.oracle(adj, cfg, start["user_emb"], start["item_emb"], **kw)


def errors(got: dict, want: dict, dim: int) -> dict:
    """Max abs error of both tables, the larger of its two ratios to the
    table's max |entry| (rel), whether every entry lies within the
    bound ``|got - want| <= atol + rtol |want|``, and whether the port's
    epoch took the warm refresh."""
    out = dict(abs=0.0, rel=0.0, ok=True, warm=got.get("warm", False))
    for name in ("user_emb", "item_emb"):
        w = want[name]
        diff = np.abs(np.asarray(got[name], dtype=np.float64) - w)
        out["abs"] = max(out["abs"], float(diff.max()))
        out["rel"] = max(out["rel"], float(
            diff.max() / max(np.abs(w).max(), 1e-30)))
        out["ok"] &= bool(np.all(diff <= atol(dim) + RTOL * np.abs(w)))
    return out


@contextlib.contextmanager
def raw_float32_eigh():
    """``woodbury.sym_eigh`` replaced by float32 ``torch.linalg.eigh``
    (what the port ran before), in this process, for the block's
    length."""
    import torch

    from safer2_recommender_tpu_torch.ops import woodbury

    saved = woodbury.sym_eigh
    woodbury.sym_eigh = torch.linalg.eigh
    try:
        yield
    finally:
        woodbury.sym_eigh = saved


@contextlib.contextmanager
def wide_budget(on: bool):
    """Every bucket wider than dim streams through column chunks
    (``assemble.WIDE_SLAB_BYTES`` 1, ``WIDE_CHUNK`` 256), as the CPU
    tests reach the wide route on small data."""
    from safer2_recommender_tpu_torch.ops import assemble

    saved = assemble.WIDE_SLAB_BYTES, assemble.WIDE_CHUNK
    if on:
        assemble.WIDE_SLAB_BYTES, assemble.WIDE_CHUNK = 1, 256
    try:
        yield
    finally:
        assemble.WIDE_SLAB_BYTES, assemble.WIDE_CHUNK = saved


def _export64(model, dd) -> dict:
    out = model.export_state(dd)
    return {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


def train_port(case: Case, cfg: Config, ds, dd, epochs: int, device):
    """The port's model on ``device``: its exported state at the top and
    after each of ``epochs`` epochs (each marked ``warm`` where the epoch
    took the warm refresh), and the rows each solve route took over the
    epochs (``woodbury.SOLVE_PATHS``)."""
    from safer2_recommender_tpu_torch.models import get_model
    from safer2_recommender_tpu_torch.ops import woodbury

    model = get_model(case.model, cfg, ds.num_users, ds.num_items,
                      device=device)
    model.initialize(dd)
    states = [_export64(model, dd)]
    woodbury.reset_solve_paths()
    for _ in range(epochs):
        warm = woodbury.SOLVE_PATHS["refresh_warm"]
        model.train_epoch(dd)
        states.append(dict(_export64(model, dd), warm=bool(
            woodbury.SOLVE_PATHS["refresh_warm"] > warm)))
    return states, dict(woodbury.SOLVE_PATHS), model


def trajectory(key: str, dim: int, start: dict, exact, epochs: int):
    """The oracle's epochs of ``key`` at ``dim`` from ``start`` on the
    data ``pairs_for(dim)``, and the host seconds they took: ([start,
    after epoch 1, ...], seconds)."""
    t0 = time.perf_counter()
    pairs = pairs_for(dim)
    adj = Adjacency(pairs[:, 0], pairs[:, 1], len(start["user_emb"]),
                    len(start["item_emb"]))
    case, cfg = CASES[key], config(key, dim)
    want = [start]
    for e in range(epochs):
        want.append(step_oracle(case, adj, cfg, want[-1], e, exact))
    return want, time.perf_counter() - t0


def decomposes(paths: dict) -> bool:
    """Whether the epoch solved rows in the full-dim eigenbasis."""
    return paths["woodbury"] + paths["rotated"] > 0


def port_case(key: str, dim: int, data, device,
              tol: Optional[float] = None) -> dict:
    """One model at one dim (at ``eig_refresh_tol`` ``tol``, None: the
    default) on ``device``: the port's epochs (and at 512 the raw
    float32 eigh's), the routes, the carried basis; the row
    ``finish_case`` completes."""
    import torch

    from safer2_recommender_tpu_torch.ops import block_chol
    from safer2_recommender_tpu_torch.probes.eigh import orthogonality

    case = CASES[key]
    ds, dd = data
    cfg = config(key, dim, tol)
    epochs = epochs_of(key, dim)
    exact = (exact_rows(dd.by_user, dd.user_perm, ds.num_users, dim),
             exact_rows(dd.by_item, dd.item_perm, ds.num_items, dim))
    before = block_chol.total_launches()
    with wide_budget(dim >= 512):
        states, paths, model = train_port(case, cfg, ds, dd, epochs, device)
        launches = block_chol.total_launches() - before
        q_orth = (orthogonality(model.state.eig_qu) if decomposes(paths)
                  else None)
        raw = None
        if dim >= 512:
            with raw_float32_eigh():
                raw, _, _ = train_port(case, cfg, ds, dd, epochs, device)
            if not np.array_equal(raw[0]["user_emb"], states[0]["user_emb"]):
                raise RuntimeError(f"{key} dim {dim}: the raw float32 run "
                                   "did not start from the same tables")
    routes = case.routes if dim >= 512 else ()
    if key in ("ialspp", "safer2pp") and dim == BLOCK_WOODBURY_DIM:
        routes = ("block", "block_woodbury")
    if dim == WARM_DIM and key in CARRIED_BASIS:
        routes = ("refresh_warm",) if cfg.eig_refresh_tol > 0 else (
            "woodbury",)
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return dict(key=key, dim=dim, tol=cfg.eig_refresh_tol, epochs=epochs,
                block=cfg.block_size, paths=paths, routes=routes,
                launches=launches, carried_orth=q_orth, states=states,
                raw=raw, exact=exact,
                missing=[r for r in routes if paths[r] == 0])


def warm_reading(part: dict) -> bool:
    """Whether the row's later epochs are the warm refresh's readings:
    a run at a nonzero ``eig_refresh_tol`` (the JAX package's
    branch)."""
    return part["tol"] > 0


def finish_case(part: dict, want, host_s: float) -> dict:
    """The row of ``port_case``'s ``part`` given the oracle's
    trajectory: each epoch's errors and the raw float32 route's;
    ``ok`` (every held epoch within the oracle's bound), ``branch_ok``
    (a reading row's later epochs warm, its first and every other row's
    epochs not), ``sharp_ok`` and ``control_ok`` (at 512: every epoch
    within ``SHARP_ABS_512``, and the raw float32 run past it where the
    epoch decomposes the full-dim Gramian)."""
    row = {k: v for k, v in part.items()
           if k not in ("states", "raw", "exact")}
    n, dim = part["epochs"], part["dim"]
    err = [errors(part["states"][e + 1], want[e + 1], dim) for e in range(n)]
    reading = warm_reading(part)
    row.update(errors=err, reading=reading,
               ok=all(e["ok"] for i, e in enumerate(err)
                      if not (reading and i > 0)),
               branch_ok=all(e["warm"] == (reading and i > 0)
                             for i, e in enumerate(err)),
               sharp_ok=dim < 512 or max(e["abs"] for e in err)
               <= SHARP_ABS_512, control_ok=True, oracle_s=host_s,
               exact=tuple(int(x.sum()) for x in part["exact"]))
    if part["raw"] is not None:
        raw = [errors(part["raw"][e + 1], want[e + 1], dim)
               for e in range(n)]
        row.update(raw=raw, control_ok=not decomposes(part["paths"]) or max(
            e["abs"] for e in raw) > SHARP_ABS_512)
    return row


def dataset(dim: int, device):
    """(Dataset, DeviceData on ``device``) of ``pairs_for``."""
    from safer2_recommender_tpu_torch import Dataset, DeviceData

    pairs = pairs_for(dim)
    ds = Dataset(pairs[:, 0], pairs[:, 1])
    return ds, DeviceData.build(ds, device=device)


def run(device="cuda", dims: Sequence[int] = DIMS) -> List[dict]:
    """Every case of ``cases(dims)`` on ``device`` (a CUDA device):
    one row each (``run_cases``)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the oracle probe runs the epochs on a CUDA "
                         f"device, not {device}")
    return run_cases(cases(dims), device)


@contextlib.contextmanager
def _one_blas_thread():
    """Processes started in the block run numpy's BLAS and LAPACK on one
    thread each: side by side, the oracle's many 512 x 512 solves run
    several times faster so than on the library's own threads."""
    names = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(dict.fromkeys(names, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cases(todo, device, workers: int = 0) -> List[dict]:
    """``port_case`` over ``todo`` ((key, dim) or (key, dim, tol), as
    ``cases`` gives them) on ``device``, one dataset per data kind,
    while the oracles' trajectories run in ``workers`` spawned processes
    (0: one a CPU core, up to 8), each from the port's initial tables;
    the rows in ``todo``'s order."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    workers = workers or min(8, os.cpu_count() or 1)
    data, parts, futures = {}, [], []
    with _one_blas_thread(), ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for key, dim, *tol in todo:
            kind = dim <= WARM_DIM
            if kind not in data:
                data[kind] = dataset(dim, device)
            part = port_case(key, dim, data[kind], device, *tol)
            parts.append(part)
            futures.append(ex.submit(trajectory, key, dim,
                                     part["states"][0], part["exact"],
                                     part["epochs"]))
        return [finish_case(part, *f.result())
                for part, f in zip(parts, futures)]


def row_ok(row: dict) -> bool:
    """The port's held epochs within the oracle's bounds and at 512
    within ``SHARP_ABS_512``, the raw float32 control past it, each
    epoch's refresh branch the expected one, and every route the epoch
    has at this dim taken."""
    return (row["ok"] and row["branch_ok"] and row["sharp_ok"]
            and row["control_ok"] and not row["missing"])


def describe(row: dict) -> str:
    def err(es, held):
        out = []
        for i, e in enumerate(es):
            tag = " (warm refresh)" if e["warm"] else ""
            if i not in held:
                tag += " (a reading)"
            elif not e["ok"]:
                tag += " OUT OF BOUND"
            out.append(f"{e['abs']:.2e} abs / {e['rel']:.2e} rel{tag}")
        return ", ".join(out)

    n = row["epochs"]
    paths = {k: v for k, v in row["paths"].items() if v}
    tol = ""
    if row["dim"] >= WARM_DIM:
        tol = f"eig_refresh_tol {row['tol']:g}" + (
            " (the JAX package's)" if row["reading"] else
            " (the default)") + ", "
    line = (f"{row['key']} dim {row['dim']} (block {row['block']}), {tol}"
            f"{row['epochs']} epoch(s): max error by epoch "
            f"{err(row['errors'], {0} if row['reading'] else range(n))}"
            f" (bound rtol {RTOL:g}, atol {atol(row['dim']):g})")
    if not row["branch_ok"]:
        line += "; REFRESH BRANCH NOT THE EXPECTED ONE"
    if "raw" in row:
        line += (f"; max abs limit {SHARP_ABS_512:g}"
                 + ("" if row["sharp_ok"] else " EXCEEDED")
                 + f"; raw float32 eigh (the control) "
                   f"{err(row['raw'], range(n))}"
                 + ("" if row["control_ok"] else
                    f" WITHIN {SHARP_ABS_512:g}: THE CONTROL PASSED"))
    line += (f"; rows by route {paths}; chol_inverse launches "
             f"{row['launches']}; exact rows (users, items) {row['exact']}"
             f"; oracle {row['oracle_s']:.2f} s on the host")
    if row["carried_orth"] is not None:
        line += f"; carried basis ||Q^T Q - I||_F {row['carried_orth']:.2e}"
    if row["missing"]:
        line += f"; ROUTES NOT TAKEN {row['missing']}"
    return line


def main(argv=None) -> int:
    import torch

    from safer2_recommender_tpu_torch import probes

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs="+", default=list(DIMS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    print(probes.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run(dims=args.dims)
    for row in rows:
        print(describe(row), flush=True)
    return 0 if all(map(row_ok, rows)) else 1


if __name__ == "__main__":
    sys.exit(main())
