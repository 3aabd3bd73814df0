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

The heavy work is the slab in the eigenbasis and a batched L x L SPD
solve (``block_chol.spd_solve``, so the hand-written kernel). The sweeps
gather that slab from the frozen table rotated once
(``models/common.py::rotate_table``) and call the ``*_in_basis`` forms;
``solve`` and ``solve_rhs`` take the plain slab and rotate it first, as
the JAX package does (one [N*L, d] x [d, d] product; the block-level
Woodbury's bases are per block, so it rotates its slices so). Every
float32 product here runs in full float32 (the entry points keep TF32
off). A bfloat16 history slab (``compute_dtype="bf16"``) is rotated
into a bfloat16 ``w``, as in the JAX package; the capacitance
``K = ws ws^T`` multiplies ``ws`` rounded to bfloat16 and accumulates in
float32, every system the solver sees is float32, and the products of
``ws`` or ``w`` with float32 vectors run in float32 (the JAX package's
bfloat16 x float32 multiply-and-sum promotes to float32).

``SOLVE_PATHS`` counts, per path, the padded bucket rows each sweep
solved (``woodbury``, ``rotated``, ``direct``; ``table_rotated`` the
rows among the Woodbury and rotated ones whose slab was gathered from
the rotated frozen table, which is all of them; ``block`` and
``block_woodbury`` are the blockwise sweeps' rows, solved block by block
directly or through the block-level Woodbury; ``wide`` counts the rows,
among the direct, block and gradient-step ones, whose histories
streamed through column chunks) and the eigenbasis refreshes
(``refresh_warm``, ``refresh_cold``). It only counts; nothing reads it
to decide anything.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from safer2_recommender_tpu_torch.ops import assemble, block_chol
from safer2_recommender_tpu_torch.utils.logging import host_read, span

# Use Woodbury only when the history width is at most dim/2 (below that
# the L x L path strictly dominates) and dim is large enough for the
# per-sweep eigh to amortize.
MIN_DIM = 128

SOLVE_PATHS: Dict[str, int] = dict.fromkeys(
    ("woodbury", "rotated", "direct", "table_rotated", "block",
     "block_woodbury", "wide", "refresh_warm", "refresh_cold"), 0)


def reset_solve_paths() -> None:
    for k in SOLVE_PATHS:
        SOLVE_PATHS[k] = 0


class WideHist(NamedTuple):
    """Column-chunked history descriptor for very long rows (zipf-head
    items or users): the [N, L, d] slab is never materialized; assembly
    streams through ``ops/assemble.py::wide_assemble``. ``table`` is in
    the assembly dtype (cast once by the caller); ``row_coef``
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


def sym_eigh(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lam ascending, Q) of the symmetric float32 [..., d, d] ``x``, both
    float32: the one eigendecomposition of the package (``maybe_eigh``,
    both branches of ``refresh_eigh``, ``models/common.py::block_eigh``).

    cuSOLVER decomposes float32 at 32 <= d <= 512 by Jacobi (``syevj``),
    whose basis reconstructs a 512 Gramian only to ~4e-4 and is
    orthogonal only to ~5e-3 (||Q^T Q - I||_F), where the JAX package's
    tests hold a cold eigh to 1e-5. So this runs in float64 and rounds
    the result (~1e-7 and ~1e-6 at every epoch shape on an H100), which
    is also the faster route there at d >= 64 (``probes/eigh.py`` part
    ``route``; PERF.md). The same route on every device; no process-wide
    setting. eigh's error check reads the device (``host_sync.eigh``)."""
    with span("host_sync.eigh"):
        lam, q = torch.linalg.eigh(x.to(torch.float64))
    return lam.to(torch.float32), q.to(torch.float32)


# Warm-started refresh: block size of the batched diagonal-block eighs
# and the minimum dim at which the JAX package takes the refresh.
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
    one device-to-host read per call (one per sweep;
    ``host_sync.refresh``).

    On an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) the warm
    branch is the dearer one at dim 512: its four float64 [128, 128]
    eighs (``sym_eigh``), the rotations and the host read take 7.1-9.9
    ms a call inside an epoch, where a full ``sym_eigh`` of the Gramian
    takes 4.9-5.4 ms and the cold branch, the full eigh after the
    coupling test, 5.3-6.9. So the port's default ``eig_refresh_tol`` is
    0, which never calls this (``maybe_eigh``); at the JAX package's
    0.08 it runs as the JAX package's does.
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
    if host_read("host_sync.refresh", coupling <= rel_tol * total):
        SOLVE_PATHS["refresh_warm"] += 1
        lam_b, qq = sym_eigh(diag)                            # [k, bs] x2
        # q <- q_prev @ blockdiag(qq): batched [d, bs] x [bs, bs]
        qp = q_prev.reshape(d, k, bs).permute(1, 0, 2)        # [k, d, bs]
        qn = torch.bmm(qp, qq)                                # [k, d, bs]
        return qn.permute(1, 0, 2).reshape(d, d), lam_b.reshape(-1)
    SOLVE_PATHS["refresh_cold"] += 1
    lam, q = sym_eigh(gram)
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
    with span("sweep.eigh"):
        if (q_prev is not None and refresh_tol > 0.0
                and dim >= _REFRESH_MIN_DIM and dim % _REFRESH_BLOCK == 0):
            q, lam = refresh_eigh(gram, q_prev, refresh_tol)
        else:
            lam, q = sym_eigh(gram)
        return q, torch.clamp(lam, min=0.0)


def applicable(width: int, dim: int) -> bool:
    return 2 * width <= dim


def _prep(emb: torch.Tensor, wt: torch.Tensor, c0: torch.Tensor,
          c1: torch.Tensor, q: torch.Tensor, lam: torch.Tensor):
    """``_prep_in_basis`` of the plain slab ``emb`` rotated into the
    eigenbasis (``w = emb Q`` in the slab's dtype)."""
    return _prep_in_basis(assemble.matmul_lowp(emb, q), wt, c0, c1, lam)


def _prep_in_basis(w: torch.Tensor, wt: torch.Tensor, c0: torch.Tensor,
                   c1: torch.Tensor, lam: torch.Tensor):
    """Shared Woodbury ingredients from the history ``w`` [N, L, d] in
    the eigenbasis, in the slab's dtype: ``w`` itself, the rotated-basis
    M^-1 diagonal ``s`` [N, d], its square root ``rs``, the f32
    weighted slab ``ws = diag(sqrt(wt)) W diag(rs)`` (the weights
    rounded to the slab's dtype first) and the f32 L x L capacitance
    ``K = ws ws^T`` from ``ws`` in the slab's dtype (its +I_L rides the
    solver's ridge). ``w`` enters only through ``ws``, so its padded
    slots may hold any finite rows (``wt`` is 0 there). XLA computes
    the JAX package's ``_prep``/``_finish`` so on the CPU; the port
    does it on every device."""
    s = 1.0 / (c1[:, None] * lam[None, :] + c0[:, None])      # [N, d]
    rs = torch.sqrt(s)
    # the weights rounded to the slab's dtype, their product with w exact
    # in f32; K multiplies its rounding to the slab's dtype (the JAX
    # package's einsum operand), the small products of _finish the f32
    # product (its bfloat16 x float32 multiply-and-sum)
    weight = (torch.sqrt(wt)[:, :, None] * rs[:, None, :]).to(w.dtype)
    ws = w.to(torch.float32) * weight.to(torch.float32)
    ws_c = ws.to(w.dtype)
    k = assemble.bmm_f32(ws_c, ws_c.transpose(1, 2))          # [N, L, L]
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
    """Batched Woodbury solve of A x = Vh^T r -> new rows [N, d], from
    the plain slab ``p.emb`` = Vh."""
    return solve_in_basis(p._replace(emb=assemble.matmul_lowp(p.emb, q)),
                          q, lam)


def solve_in_basis(p: SolveParams, q: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """``solve`` with ``p.emb`` already in the eigenbasis (Vh Q)."""
    w, s, rs, ws, k = _prep_in_basis(p.emb, p.wt, p.c0, p.c1, lam)
    # Q^T Vh^T r
    rv = torch.bmm(p.r[:, None, :], w.to(torch.float32))[:, 0, :]
    del w
    return _finish(s * rv, s, rs, ws, k, q)


def solve_rhs(emb: torch.Tensor, wt: torch.Tensor, c0: torch.Tensor,
              c1: torch.Tensor, b: torch.Tensor, q: torch.Tensor,
              lam: torch.Tensor) -> torch.Tensor:
    """Batched Woodbury solve of A x = b for an ARBITRARY rhs b [N, d]
    (the blockwise models' delta systems, whose rhs mixes residual,
    local-global-Gramian and regularizer pull-back terms; see
    ``models/common.py::block_sweep_frozen``). Same A as ``solve``:
    A = c0 I + c1 G + emb^T diag(wt) emb with G = Q diag(lam) Q^T."""
    return solve_rhs_in_basis(assemble.matmul_lowp(emb, q), wt, c0, c1,
                              b @ q, q, lam)


def solve_rhs_in_basis(w: torch.Tensor, wt: torch.Tensor, c0: torch.Tensor,
                       c1: torch.Tensor, b_rot: torch.Tensor,
                       q: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """``solve_rhs`` with the slab ``w`` = emb Q and the rhs
    ``b_rot`` = b Q both in the eigenbasis."""
    _, s, rs, ws, k = _prep_in_basis(w, wt, c0, c1, lam)
    return _finish(s * b_rot, s, rs, ws, k, q)
