"""SAFER2++'s epoch in the frozen order, plain PyTorch
(safer2pp.h:97-216, 288-355).

As SAFER2's epoch (``safer2.py``), but the z-step runs over every id
(safer2pp.h:839-862), and each side is one pass of block coordinate
descent in blocks of ``block_size`` from the row's current value, every
block of U against the frozen V, then every block of V against the new
U. The program's documented rule solves a row whose history fits in
dim / 2 slots exactly instead (at dim >= 128, where its full-dim
eigenbasis is on), which the block pass converges to; so does this
reference.
"""

from __future__ import annotations

from typing import Optional

from portbench.reference import safer2
from portbench.reference.common import Prec

Problem = safer2.Problem
start_state = safer2.start_state

# the dim from which the program's full-dim eigenbasis is on
EXACT_FROM_DIM = 128


def exact_max(cfg: dict) -> int:
    """The longest history solved exactly (-1: none)."""
    return cfg["dim"] // 2 if cfg["dim"] >= EXACT_FROM_DIM else -1


def epoch(prob: Problem, state: dict, gen, prec: Prec,
          fault: Optional[str] = None) -> dict:
    cfg = prob.cfg
    loss, xi, z = safer2.z_step(prob, state, gen, prec, every_id=True)
    u1, v1, g1 = safer2._sides(prob, state, z, prec, fault,
                               block=cfg["block_size"],
                               exact_max=exact_max(cfg))
    return dict(user_emb=u1, item_emb=v1, gram=g1, user_loss=loss,
                dual_weight=z, xi=xi, steps=state["steps"] + 1)
