"""Batched SPD solve entry point (the counterpart of
``safer2_recommender_tpu/ops/solve.py``): the direct path through
``ops/block_chol.py``. The conjugate-gradient path (``--use_cg``) is
not ported yet (ROADMAP Queue 1 item 14)."""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.ops.block_chol import spd_solve

CG_NOT_PORTED = ("use_cg=True: the conjugate-gradient solver is not "
                 "ported to PyTorch yet (ROADMAP Queue 1 item 14)")


def solve(a: torch.Tensor, b: torch.Tensor, *, use_cg: bool = False,
          ridge=None) -> torch.Tensor:
    """Solve (a + diag(ridge)) x = b; the ridge (the normal equations'
    reg * I) is applied inside the solver, never as a slab-wide add."""
    if use_cg:
        raise NotImplementedError(CG_NOT_PORTED)
    return spd_solve(a, b, ridge)
