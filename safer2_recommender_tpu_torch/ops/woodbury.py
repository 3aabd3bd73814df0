"""Per-bucket ingredients of the normal equations, and the gate of the
Woodbury path (the counterpart of ``safer2_recommender_tpu/ops/
woodbury.py``).

Every exact solve has the structure

    A_u   = c0_u * I + c1_u * G + Vh_u^T diag(wt_u) Vh_u
    rhs_u = Vh_u^T r_u

with ``G`` a shared d x d Gramian. At dim >= ``MIN_DIM`` the JAX package
solves narrow rows through one shared eigendecomposition of ``G``
(Woodbury); that path is not ported yet (ROADMAP Queue 1 item 8), so
below ``MIN_DIM`` every solve is direct and at or above it the port
refuses to run rather than take another path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MIN_DIM = 128

WOODBURY_NOT_PORTED = (
    f"dim >= {MIN_DIM} takes the Woodbury solve path in the JAX package; "
    "it is not ported to PyTorch yet (ROADMAP Queue 1 item 8)")


class SolveParams(NamedTuple):
    """``emb`` is the masked [N, L, d] history slab; ``wt``/``r`` are
    [N, L] (masked; ``wt`` >= 0); ``c0``/``c1`` are [N]."""

    emb: torch.Tensor
    wt: torch.Tensor
    r: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor


def maybe_eigh(gram: torch.Tensor, dim: int, *, use_cg: bool):
    """(Q, lam) of the shared Gramian when the Woodbury path is on: None
    for CG or below ``MIN_DIM`` (the direct path); raises where the JAX
    package would decompose ``gram``."""
    if use_cg or dim < MIN_DIM:
        return None
    raise NotImplementedError(WOODBURY_NOT_PORTED)
