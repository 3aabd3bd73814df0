"""Model FLOPs of one SAFER2++ epoch in the frozen order: the least work
for these inputs. A row whose history fits in dim / 2 slots is solved
exactly (the program's documented rule, at dim >= 128): the rank-L
product of its observed factors, L d^2 FLOPs as in ``mf_gramian``. Any
other row runs one pass over the d / b blocks, each forming the rank-L
product of its b columns, L b^2 a block: L b d a row."""

from __future__ import annotations

import numpy as np

EXACT_FROM_DIM = 128


def epoch_flops(cfg: dict, user_lengths: np.ndarray,
                item_lengths: np.ndarray) -> float:
    d, b = cfg["dim"], cfg["block_size"]
    cut = d // 2 if d >= EXACT_FROM_DIM else -1
    total = 0.0
    for lens in (user_lengths, item_lengths):
        exact = lens <= cut
        total += float(lens[exact].sum()) * d * d
        total += float(lens[~exact].sum()) * b * d
    return total
