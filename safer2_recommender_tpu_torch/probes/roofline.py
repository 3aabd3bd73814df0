"""The rates the card attains on the operations a roofline is read
against (the counterpart of the JAX package's
``scripts/profile_roofline.py``).

    python -m safer2_recommender_tpu_torch.probes.roofline

On the CUDA device, each timed by CUDA events around every launch after
a warm-up, the median of ``REPS`` launches (min and max beside it):

- a 4,096 x 4,096 float32 matmul at ``"highest"`` (the FFMA pipe outside
  the tensor cores, which the MSD epoch's f32 GEMMs run on), in TF32
  (``"high"``) and in bfloat16;
- the batched Cholesky factor of [928, 256, 256] SPD matrices
  (``torch.linalg.cholesky_ex``);
- the triangular solve of [928, 256] right-hand sides against those
  factors (``torch.linalg.solve_triangular``);
- a device-to-device copy of 1 GiB (bytes read plus bytes written).

FLOPs are counted as the JAX script counts them: 2 d^3 a matmul,
2 n d^3 / 3 the Cholesky, n d^2 the solve. Each rate is printed beside
the published peak of one H100 SXM at its 700 W limit (67 TFLOP/s f32,
495 TF32, 989 bf16, 3.35 TB/s) and the card's own power limit. These are
library calls used to measure the card, not kernels of the port.
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable, List

import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.utils.device import matmul_precision

D = 4096              # the matmul's size
N, DC = 928, 256      # the batched Cholesky and solve
COPY_BYTES = 1 << 30
REPS, WARMUP = 30, 5
BF16_TENSOR_FLOP_PER_S = 989e12


def matmul_flop() -> float:
    return 2 * D ** 3


def chol_flop() -> float:
    return 2 * (N * DC ** 3 / 3)


def trisolve_flop() -> float:
    return N * DC ** 2


def launch_ms(fn: Callable) -> List[float]:
    """ms of each of ``REPS`` launches of ``fn``, CUDA events around
    each, after ``WARMUP`` launches (``probes.cuda_ms`` times a run of
    launches as one, which gives no median)."""
    for _ in range(WARMUP):
        fn()
    pairs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def _row(name: str, ms: List[float], work: float, peak: float,
         unit: str) -> dict:
    med = statistics.median(ms)
    rate = work / (med / 1e3)
    return {"name": name, "ms": med, "min_ms": min(ms), "max_ms": max(ms),
            unit: work, "rate": rate, "peak": peak, "share": rate / peak}


def run(device="cuda") -> List[dict]:
    """Measure every row on ``device`` (a CUDA device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline probe measures a CUDA device, not "
                         f"{dev}")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    m = torch.randn(D, D, device=dev, generator=g) * 0.01
    for label, precision, peak in (
            ("f32 highest", "highest", probes.F32_FLOP_PER_S),
            ("tf32", "high", probes.TF32_TENSOR_FLOP_PER_S)):
        with matmul_precision(precision):
            rows.append(_row(f"matmul {D} {label}",
                             launch_ms(lambda: m @ m), matmul_flop(),
                             peak, "flop"))
    mb = m.to(torch.bfloat16)
    rows.append(_row(f"matmul {D} bf16", launch_ms(lambda: mb @ mb),
                     matmul_flop(), BF16_TENSOR_FLOP_PER_S, "flop"))
    del m, mb

    with matmul_precision("highest"):
        x = torch.randn(N, DC, DC, device=dev, generator=g)
        a = x @ x.transpose(1, 2) + 10.0 * torch.eye(DC, device=dev)
    del x
    rows.append(_row(f"chol [{N},{DC},{DC}]",
                     launch_ms(lambda: torch.linalg.cholesky_ex(a)),
                     chol_flop(), probes.F32_FLOP_PER_S, "flop"))
    low = torch.linalg.cholesky_ex(a).L
    b = torch.randn(N, DC, 1, device=dev, generator=g)
    rows.append(_row(f"trisolve [{N},{DC}]", launch_ms(
        lambda: torch.linalg.solve_triangular(low, b, upper=False)),
        trisolve_flop(), probes.F32_FLOP_PER_S, "flop"))
    del a, low, b

    src = torch.empty(COPY_BYTES // 4, device=dev)
    dst = torch.empty_like(src)
    rows.append(_row("copy d2d 1 GiB", launch_ms(lambda: dst.copy_(src)),
                     2 * COPY_BYTES, probes.HBM_BYTES_PER_S, "bytes"))
    return rows


def describe(row: dict) -> str:
    if "flop" in row:
        rate = (f"{row['rate'] / 1e12:.2f} TFLOP/s of {row['peak'] / 1e12:g}"
                f" published")
    else:
        rate = (f"{row['rate'] / 1e12:.3f} TB/s of {row['peak'] / 1e12:g} "
                f"published")
    return (f"{row['name']}: {row['ms']:.4f} ms median of {REPS} "
            f"({row['min_ms']:.4f}-{row['max_ms']:.4f}), {rate} "
            f"({100 * row['share']:.1f}%)")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    print(probes.nvidia_smi(), flush=True)
    for row in run():
        print(describe(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
