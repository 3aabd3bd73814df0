"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit) and the least time of the port's inverse-Cholesky
kernel.

Origin (copied at commit fcae2312b1ea72c586087e9a4a161dd4d15691d9):
``safer2_recommender_tpu_torch/probes/__init__.py::bound`` and
``safer2_recommender_tpu_torch/probes/chol_inverse.py::bound``: the bytes
``inv(chol(a + diag(ridge)))`` needs (the lower triangle of each system
and its ridge read once, the whole of out written once) at 3.35 TB/s
against its FLOPs (2 r^3 / 3 a system: r^3 / 3 for the factor, as many
for its inverse) at 67 TFLOP/s, the float32 rate outside the tensor
cores, whichever is longer.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flop: float,
             flop_per_s: float = F32_FLOP_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flop / flop_per_s) * 1e3


def chol_inverse_ms(n: int, r: int) -> float:
    """Least time of ``inv(chol(.))`` over n systems of size r."""
    return bound_ms(4 * n * (r * (r + 1) // 2 + r + r * r),
                    n * 2 * r ** 3 / 3)
