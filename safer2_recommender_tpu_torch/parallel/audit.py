"""Collective-traffic accounting of a mesh (the counterpart of
``safer2_recommender_tpu/parallel/audit.py``).

The JAX package reads the collectives out of the compiled HLO. The port
has no HLO: it issues each collective itself, through
``parallel/mesh.py``, which records it here. The convention is the JAX
package's: bytes are the per-device result shape's (an all-gather counts
the gathered array each rank ends up holding, an all-reduce its shape
once, though a ring moves about twice that), a proxy for link traffic
whose purpose is budgets and orders of magnitude. A barrier counts a
call and no bytes.
"""

from __future__ import annotations

from typing import Dict, Tuple


class Traffic:
    """``{kind: (calls, result bytes)}`` of the collectives one mesh
    issued since the last ``reset``."""

    def __init__(self):
        self._by_kind: Dict[str, Tuple[int, int]] = {}

    def record(self, kind: str, nbytes: int) -> None:
        calls, total = self._by_kind.get(kind, (0, 0))
        self._by_kind[kind] = (calls + 1, total + int(nbytes))

    def reset(self) -> None:
        self._by_kind = {}

    def snapshot(self) -> Dict[str, Tuple[int, int]]:
        return dict(self._by_kind)


def total_bytes(traffic: Dict[str, Tuple[int, int]]) -> int:
    return sum(b for _, b in traffic.values())


def total_calls(traffic: Dict[str, Tuple[int, int]]) -> int:
    return sum(c for c, _ in traffic.values())
