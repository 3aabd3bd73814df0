"""Batched SPD solve entry points (the counterpart of
``safer2_recommender_tpu/ops/solve.py``): the direct path through
``ops/block_chol.py`` and the conjugate-gradient path of the reference's
``--use_cg`` (``Eigen::ConjugateGradient``, reference ials.h:133-138)."""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.ops.block_chol import spd_solve
from safer2_recommender_tpu_torch.utils.logging import host_read

# How many CG iterations run between two convergence tests: each test
# reads the host once.
CG_CHECK_EVERY = 8


def _capturing(x: torch.Tensor) -> bool:
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def cg_solve(a: torch.Tensor, b: torch.Tensor, *, tol: float = 1e-10,
             max_iters: int = 100, ridge=None) -> torch.Tensor:
    """Batched conjugate gradient on (a + diag(ridge)) x = b, a [N, d, d],
    b [N, d]; ``ridge`` None, [N] or [N, d] enters the matvec (never
    materialized).

    Eigen's relative tolerance: a system is converged once
    ||r||^2 <= tol^2 ||b||^2. Each system freezes when it converges (or
    its curvature p^T A p is not positive): alpha = beta = 0 and x, r, p
    are kept, so further iterations leave it exactly as it was. The
    batch stops once every system has converged, tested every
    ``CG_CHECK_EVERY`` iterations, or after ``max_iters``: the JAX
    package's ``lax.while_loop``, whose whole-batch exit is tested every
    iteration, gives the same x. Under CUDA graph capture (no host read
    is allowed there) exactly ``max_iters`` iterations run, which again
    gives the same x.
    """
    b_norm2 = (b * b).sum(dim=-1)
    thresh = (tol * tol) * b_norm2
    rg = None
    if ridge is not None:
        rg = ridge[:, None] if ridge.dim() == 1 else ridge
    x = torch.zeros_like(b)
    r, p, rs = b, b, b_norm2
    test = not _capturing(b)
    for i in range(max_iters):
        if (test and i % CG_CHECK_EVERY == 0
                and not host_read("host_sync.cg", (rs > thresh).any())):
            break
        ap = torch.bmm(a, p[:, :, None])[:, :, 0]
        if rg is not None:
            ap = ap + rg * p
        denom = (p * ap).sum(dim=-1)
        live = (rs > thresh) & (denom > 0)
        alpha = torch.where(live, rs / denom.clamp(min=1e-30), 0.0)
        x = torch.where(live[:, None], x + alpha[:, None] * p, x)
        r = torch.where(live[:, None], r - alpha[:, None] * ap, r)
        rs_new = torch.where(live, (r * r).sum(dim=-1), rs)
        beta = torch.where(live, rs_new / rs.clamp(min=1e-30), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = rs_new
    return x


def solve(a: torch.Tensor, b: torch.Tensor, *, use_cg: bool = False,
          tol: float = 1e-10, max_iters: int = 100,
          ridge=None) -> torch.Tensor:
    """Solve (a + diag(ridge)) x = b; the ridge (the normal equations'
    reg * I) is applied inside the solver, never as a slab-wide add."""
    if use_cg:
        return cg_solve(a, b, tol=tol, max_iters=max_iters, ridge=ridge)
    return spd_solve(a, b, ridge)
