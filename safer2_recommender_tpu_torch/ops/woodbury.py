"""Woodbury solves: d x d normal equations as L x L ones (the
counterpart of ``safer2_recommender_tpu/ops/woodbury.py``).

Every exact solve has the structure

    A_u   = c0_u * I + c1_u * G + Vh_u^T diag(wt_u) Vh_u
    rhs_u = Vh_u^T r_u

with ``G`` a shared d x d Gramian. For rows whose history L is at most
d/2, one shared eigendecomposition ``G = Q diag(lam) Q^T`` per sweep
shrinks the per-row solve to L x L:

    M_u      = c0_u I + c1_u G          (diagonal in the shared eigenbasis)
    M_u^-1   = Q diag(s_u) Q^T,  s_u = 1 / (c1_u * lam + c0_u)
    A_u      = M_u + Vt_u^T Vt_u,  Vt_u = diag(sqrt(wt_u)) Vh_u
    A_u^-1 b = M^-1 b - M^-1 Vt^T (I_L + Vt M^-1 Vt^T)^-1 Vt M^-1 b

The heavy work is one [N*L, d] x [d, d] product into the eigenbasis and
a batched L x L SPD solve (``block_chol.spd_solve``, so the hand-written
kernel). Every product here runs in full float32: PyTorch keeps TF32 off
for float32 matmuls unless a caller turns it on.

``SOLVE_PATHS`` counts, per path, the padded bucket rows each sweep
solved (``woodbury``, ``rotated``, ``direct``; ``wide`` counts the rows
among the direct ones whose histories streamed through column chunks)
and the eigenbasis refreshes (``refresh_warm``, ``refresh_cold``). It
only counts; nothing reads it to decide anything.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from safer2_recommender_tpu_torch.ops import block_chol

# Use Woodbury only when the history width is at most dim/2 (below that
# the L x L path strictly dominates) and dim is large enough for the
# per-sweep eigh to amortize.
MIN_DIM = 128

SOLVE_PATHS: Dict[str, int] = dict.fromkeys(
    ("woodbury", "rotated", "direct", "wide", "refresh_warm",
     "refresh_cold"), 0)


def reset_solve_paths() -> None:
    for k in SOLVE_PATHS:
        SOLVE_PATHS[k] = 0


class WideHist(NamedTuple):
    """Column-chunked history descriptor for very long rows (zipf-head
    items or users): the [N, L, d] slab is never materialized; assembly
    streams through ``ops/assemble.py::wide_assemble``. ``row_coef``
    ([N] or None) scales the accumulated history terms; ``extra_vec`` is
    a per-row scalar table gathered alongside (the dual weight on the
    item side)."""

    table: torch.Tensor
    bucket: object
    row_coef: Optional[torch.Tensor]
    extra_vec: Optional[torch.Tensor]


class SolveParams(NamedTuple):
    """``emb`` is the masked [N, L, d] history slab; ``wt``/``r`` are
    [N, L] (masked; ``wt`` >= 0); ``c0``/``c1`` are [N]. When ``wide`` is
    set, emb/wt/r are None and the history terms stream through column
    chunks (always the direct d x d path: wide rows have width > dim)."""

    emb: Optional[torch.Tensor]
    wt: Optional[torch.Tensor]
    r: Optional[torch.Tensor]
    c0: torch.Tensor
    c1: torch.Tensor
    wide: Optional[WideHist] = None


# Warm-started refresh: block size of the batched diagonal-block eighs
# and the minimum dim at which the refresh pays.
_REFRESH_BLOCK = 128
_REFRESH_MIN_DIM = 256


def refresh_eigh(gram: torch.Tensor, q_prev: torch.Tensor,
                 rel_tol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warm-started spectral decomposition Q diag(lam) Q^T ~= gram.

    The Gramian drifts slowly between ALS sweeps, and the solve needs
    only an orthogonal Q and a diagonal lam that reconstruct it closely
    (clustered directions may mix freely). So: rotate the new Gramian
    into the previous basis (B = Q^T G Q, nearly block diagonal), eigh
    only the 128-wide diagonal blocks (one batched eigh), and keep the
    block-diagonalizing update Q <- Q blkdiag(Qk). The dropped
    off-diagonal coupling is measured every call; when it exceeds
    ``rel_tol * ||B||_F`` the full eigh runs instead.

    The JAX package chooses the branch on the device (``lax.cond``);
    here the choice is a Python branch on the coupling test, which costs
    one device-to-host read per call (one per sweep).
    """
    d = gram.shape[0]
    k = d // _REFRESH_BLOCK
    bs = _REFRESH_BLOCK
    b = q_prev.T @ (gram @ q_prev)
    b = 0.5 * (b + b.T)
    blocks = b.reshape(k, bs, k, bs).permute(0, 2, 1, 3)     # [k, k, bs, bs]
    idx = torch.arange(k, device=b.device)
    diag = blocks[idx, idx]                                   # [k, bs, bs]
    total = torch.linalg.norm(b)
    coupling = torch.sqrt(torch.clamp(
        torch.square(total) - torch.sum(torch.square(diag)), min=0.0))
    if bool(coupling <= rel_tol * total):
        SOLVE_PATHS["refresh_warm"] += 1
        lam_b, qq = torch.linalg.eigh(diag)                   # [k, bs] x2
        # q <- q_prev @ blockdiag(qq): batched [d, bs] x [bs, bs]
        qp = q_prev.reshape(d, k, bs).permute(1, 0, 2)        # [k, d, bs]
        qn = torch.bmm(qp, qq)                                # [k, d, bs]
        return qn.permute(1, 0, 2).reshape(d, d), lam_b.reshape(-1)
    SOLVE_PATHS["refresh_cold"] += 1
    lam, q = torch.linalg.eigh(gram)
    return q, lam


def maybe_eigh(gram: torch.Tensor, dim: int, *, use_cg: bool,
               q_prev: Optional[torch.Tensor] = None,
               refresh_tol: float = 0.0,
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(Q, lam) of the shared Gramian when the Woodbury path is on: None
    for CG or below ``MIN_DIM`` (the direct path).

    With ``q_prev`` (the previous sweep's basis, carried in model state)
    and ``refresh_tol > 0``, uses the warm-started ``refresh_eigh``."""
    if use_cg or dim < MIN_DIM:
        return None
    if (q_prev is not None and refresh_tol > 0.0
            and dim >= _REFRESH_MIN_DIM and dim % _REFRESH_BLOCK == 0):
        q, lam = refresh_eigh(gram, q_prev, refresh_tol)
    else:
        lam, q = torch.linalg.eigh(gram)
    return q, torch.clamp(lam, min=0.0)


def applicable(width: int, dim: int) -> bool:
    return 2 * width <= dim


def _prep(emb: torch.Tensor, wt: torch.Tensor, c0: torch.Tensor,
          c1: torch.Tensor, q: torch.Tensor, lam: torch.Tensor):
    """Shared Woodbury ingredients: rotated history ``w`` [N, L, d],
    rotated-basis M^-1 diagonal ``s`` [N, d], its square root ``rs``, the
    weighted slab ``ws = diag(sqrt(wt)) W diag(rs)`` and the L x L
    capacitance ``K = ws ws^T`` (its +I_L rides the solver's ridge)."""
    w = emb @ q                                               # [N, L, d]
    s = 1.0 / (c1[:, None] * lam[None, :] + c0[:, None])      # [N, d]
    rs = torch.sqrt(s)
    ws = w * (torch.sqrt(wt)[:, :, None] * rs[:, None, :])
    k = torch.bmm(ws, ws.transpose(1, 2))                     # [N, L, L]
    return w, s, rs, ws, k


def _finish(z: torch.Tensor, s: torch.Tensor, rs: torch.Tensor,
            ws: torch.Tensor, k: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """x = Q (z - s Vt^T (K+I)^-1 Vt z) given the rotated M^-1 rhs z.
    ``Vt z`` in the rotated basis is ``ws (z / rs)`` and ``Vt^T y`` is
    ``(ws^T y) / rs``: the sqrt factors ride the small vectors only."""
    u = torch.bmm(ws, (z / rs)[:, :, None])[:, :, 0]          # [N, L]
    y = block_chol.spd_solve(
        k, u, torch.ones((k.shape[0],), dtype=k.dtype, device=k.device))
    wty = torch.bmm(ws.transpose(1, 2), y[:, :, None])[:, :, 0] / rs
    return (z - s * wty) @ q.T                                # [N, d]


def solve(p: SolveParams, q: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Batched Woodbury solve of A x = Vh^T r -> new rows [N, d]."""
    w, s, rs, ws, k = _prep(p.emb, p.wt, p.c0, p.c1, q, lam)
    rv = torch.bmm(p.r[:, None, :], w)[:, 0, :]               # Q^T Vh^T r
    del w
    return _finish(s * rv, s, rs, ws, k, q)
