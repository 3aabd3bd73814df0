"""Model FLOPs of one SAFER2 epoch: the least work its exact sweeps
need for these inputs. Each row with L observed items forms the rank-L
product of its observed factors, a symmetric d x d matrix: L d (d + 1) / 2
multiply-adds, counted as L d^2 FLOPs, for every row of both sides.
The solves, right-hand sides and losses are left out, so no
implementation of the epoch can read over 100%."""

from __future__ import annotations

import numpy as np


def epoch_flops(cfg: dict, user_lengths: np.ndarray,
                item_lengths: np.ndarray) -> float:
    d = cfg["dim"]
    return float(user_lengths.sum() + item_lengths.sum()) * d * d
