"""Batched small-matrix products on the GPU: the hand-written ``bdot``
kernel against plain ``torch.bmm`` (the counterpart of
``scripts/probe_bdot.py``, which asked the same of XLA and Pallas on a
TPU).

    python -m safer2_recommender_tpu_torch.probes.bdot

Prints one line per matrix size h in {32, 64, 128}: the chained product
``acc = (acc @ x) * 1e-2`` over 8 products at [4096, h, h] through
the kernel, through plain ``torch.bmm`` in full f32, and through plain
``torch.bmm`` with TF32 on (the nearest analog of the TPU probe's
DEFAULT precision), each in ms and TFLOP/s. Then one line per distinct
batched product that ``block_chol.spd_solve`` issues for
[512, 512, 512] systems (the dim-512 blocked factorization and
substitutions), recorded from a run of it, with plain ``torch.matmul``
timed at that shape. Times are CUDA events after warm-up; a machine
without CUDA is an error.
"""

from __future__ import annotations

import sys
from collections import Counter
from typing import Dict, List

import torch
from torch.overrides import TorchFunctionMode

from safer2_recommender_tpu_torch.ops import bdot as bdot_op
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.probes import cuda_ms

SIZES = bdot_op.SIZES
SCALE = 1e-2
N = 4096          # matrices per batch, as the TPU probe
N_DOTS = 8        # chained products per call, as the TPU probe
SOLVER_N = 512    # [SOLVER_N, 512, 512] systems for the solver's products


class _RecordProducts(TorchFunctionMode):
    """Count the operand shapes of every batched (3-D) matrix product."""

    _NAMES = ("matmul", "__matmul__", "bmm")

    def __init__(self):
        super().__init__()
        self.shapes: Counter = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", None) in self._NAMES
                and len(args) >= 2 and args[0].dim() == 3):
            self.shapes[(tuple(args[0].shape), tuple(args[1].shape))] += 1
        return func(*args, **(kwargs or {}))


def solver_product_shapes(n_sys: int, d: int, device) -> Counter:
    """{(a shape, b shape): count} of the batched products that
    ``spd_solve`` issues for [n_sys, d, d] systems, recorded from one
    run on random SPD systems."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randn((n_sys, d, d), generator=gen, device=device) / d ** 0.5
    a = x @ x.transpose(1, 2)
    b = torch.randn((n_sys, d), generator=gen, device=device)
    rec = _RecordProducts()
    with rec:
        block_chol.spd_solve(a, b, torch.ones(n_sys, device=device))
    return rec.shapes


def _tflops(flop: float, ms: float) -> float:
    return flop / (ms * 1e-3) / 1e12


def run(device="cuda") -> Dict[str, List[dict]]:
    """Measure and print; returns {"bdot": rows by h, "solver": rows by
    product shape}. Each ``bdot`` call here is a kernel launch and adds
    to ``bdot_op.LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe measures the GPU; give a CUDA device")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for h in SIZES:
        x = torch.randn((N, h, h), generator=gen, device=device) * 0.1
        flop = 2.0 * N * h ** 3 * N_DOTS
        ms = cuda_ms(lambda: bdot_op.bdot(x, N_DOTS, SCALE))
        plain_ms = cuda_ms(lambda: bdot_op.bdot_ref(x, N_DOTS, SCALE))
        tf32_was = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(lambda: bdot_op.bdot_ref(x, N_DOTS, SCALE))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
        row = dict(h=h, n=N, n_dots=N_DOTS, ms=ms, plain_ms=plain_ms,
                   plain_tf32_ms=tf32_ms, tflops=_tflops(flop, ms),
                   plain_tflops=_tflops(flop, plain_ms),
                   plain_tf32_tflops=_tflops(flop, tf32_ms))
        rows.append(row)
        print(f"[probe bdot] h={h:3d} N={N} dots={N_DOTS}: kernel "
              f"{ms:.4f} ms ({row['tflops']:.2f} TFLOP/s); torch.bmm f32 "
              f"{plain_ms:.4f} ms ({row['plain_tflops']:.2f} TFLOP/s); "
              f"torch.bmm TF32 (nearest analog of the TPU's DEFAULT "
              f"precision) {tf32_ms:.4f} ms "
              f"({row['plain_tf32_tflops']:.2f} TFLOP/s)", flush=True)

    solver = []
    for (sa, sb), count in sorted(
            solver_product_shapes(SOLVER_N, 512, device).items()):
        a = torch.randn(sa, generator=gen, device=device)
        b = torch.randn(sb, generator=gen, device=device)
        ms = cuda_ms(lambda: torch.matmul(a, b))
        flop = 2.0 * sa[0] * sa[1] * sa[2] * sb[-1]
        solver.append(dict(a=list(sa), b=list(sb), count=count, ms=ms,
                           tflops=_tflops(flop, ms)))
        print(f"[probe bdot] spd_solve [{SOLVER_N}, 512, 512] product "
              f"{list(sa)} @ {list(sb)} x{count}: torch.matmul f32 "
              f"{ms:.4f} ms ({_tflops(flop, ms):.2f} TFLOP/s)", flush=True)
    return {"bdot": rows, "solver": solver}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
