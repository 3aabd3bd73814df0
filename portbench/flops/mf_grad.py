"""Model FLOPs and compulsory bytes of one CVaR-MF epoch's two gradient
steps (the U and V sweeps): the least work and traffic for these
inputs, so no implementation of the sweeps can read over 100% of
``frozen/bounds.py``'s roofline.

FLOPs: each observed slot of a side costs 4 d (the dot o . x and the
weighted add of o into A x - rhs); each row with a history 2 d^2 for
its Gramian term x G; and the V step's symmetric U^T diag(z) U, d (d + 1)
/ 2 multiply-adds a user, counted as d^2. The losses and V^T V are left
out.

Bytes (float32 tables, int32 indices): each side's table read and
written once, the frozen table and its d x d Gramian read once, and the
side's history indices read once.
"""

from __future__ import annotations

import numpy as np

F32 = 4
INDEX = 4


def epoch_flops(cfg: dict, user_lengths: np.ndarray,
                item_lengths: np.ndarray) -> float:
    d = cfg["dim"]
    total = 0.0
    for lens in (user_lengths, item_lengths):
        total += 4.0 * d * float(lens.sum())
        total += 2.0 * d * d * float(np.count_nonzero(lens))
    return total + float(d * d) * user_lengths.size


def epoch_bytes(cfg: dict, user_lengths: np.ndarray,
                item_lengths: np.ndarray) -> float:
    d = cfg["dim"]
    total = 0.0
    for lens, other in ((user_lengths, item_lengths),
                        (item_lengths, user_lengths)):
        total += 2.0 * F32 * d * lens.size          # own table, read + write
        total += F32 * d * other.size + F32 * d * d  # frozen table, Gramian
        total += INDEX * float(lens.sum())          # history indices
    return total
