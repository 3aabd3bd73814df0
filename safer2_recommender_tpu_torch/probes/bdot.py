"""Batched small-matrix powers on the GPU: the hand-written ``bdot``
kernel against its plain version and ``torch.linalg.matrix_power`` (the
counterpart of ``scripts/probe_bdot.py``, which asked the same of XLA and
Pallas on a TPU).

    python -m safer2_recommender_tpu_torch.probes.bdot

For each matrix size h in {32, 64, 128}, at [4096, h, h] and 8 dots (the
function x^9 * 1e-2^8), one line per precision, timed in turns:
- "highest" (f32 accuracy; three TF32 passes in the kernel): the kernel
  per call and from a CUDA graph, its plain version ``bdot_ref`` (f32
  ``torch.bmm``) and the library call ``torch.linalg.matrix_power`` in
  f32, scaled;
- "default" (one TF32 pass): the kernel, ``bdot_ref`` on TF32-rounded
  operands, and ``matrix_power`` with TF32 on (``allow_tf32`` restored
  after each call).
Each beside its ``bound`` and the share of it. TFLOP/s are of the
products the kernel runs, ``products_needed`` (4 at 8 dots). Then one
line per distinct batched product that ``block_chol.spd_solve`` issues
for [512, 512, 512] systems (the dim-512 blocked factorization and
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

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.ops import bdot as bdot_op
from safer2_recommender_tpu_torch.ops import block_chol

SIZES = bdot_op.SIZES
SCALE = 1e-2
N = 4096          # matrices per batch, as the TPU probe
N_DOTS = 8        # the chain's products, as the TPU probe
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


def products_needed(n_dots: int) -> int:
    """Matrix products that x^(n_dots + 1), the function of the chain,
    needs by repeated squaring: one per bit of m = n_dots + 1 below the
    top one, and one more per further set bit (4 at 8 dots: x^2, x^4,
    x^8, x^9). No shorter chain exists for m < 15."""
    m = n_dots + 1
    return m.bit_length() - 1 + bin(m).count("1") - 1


def bound(n: int, h: int, n_dots: int, precision: str) -> dict:
    """Least time of ``bdot`` over [n, h, h]: x read and out written once,
    against the FLOPs of the fewest products at the precision's rate:
    "default" one TF32 tensor-core pass; "highest" the faster of three
    TF32 passes and f32 FMA outside the tensor cores."""
    rate = max(probes.TF32_TENSOR_FLOP_PER_S / bdot_op.PASSES[precision],
               probes.F32_FLOP_PER_S)
    return probes.bound(2 * 4 * n * h * h,
                        2.0 * n * h ** 3 * products_needed(n_dots), rate)


def _tflops(flop: float, ms: float) -> float:
    return flop / (ms * 1e-3) / 1e12


def _matrix_power_tf32(x: torch.Tensor) -> torch.Tensor:
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.linalg.matrix_power(x, N_DOTS + 1) * SCALE ** N_DOTS
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def measure(x: torch.Tensor, precision: str) -> dict:
    """Times at [N, h, h] and one precision, in turns: the kernel per
    call (``ms``) and from a CUDA graph (``graph_ms``), the plain version
    and the library call; with the bound and the shares of it."""
    n, h = x.shape[0], x.shape[1]
    if precision == "highest":
        library = lambda: (torch.linalg.matrix_power(x, N_DOTS + 1)
                           * SCALE ** N_DOTS)
    else:
        library = lambda: _matrix_power_tf32(x)
    fns = {
        "plain_ms": lambda: bdot_op.bdot_ref(x, N_DOTS, SCALE, precision),
        "library_ms": library,
        "ms": lambda: bdot_op.bdot(x, N_DOTS, SCALE, precision),
    }
    row = probes.in_turns(fns)
    row["graph_ms"] = probes.graph_ms(fns["ms"])
    row.update(bound(n, h, N_DOTS, precision))
    products = products_needed(N_DOTS)
    flop = 2.0 * n * h ** 3 * products
    row.update(h=h, n=n, n_dots=N_DOTS, precision=precision,
               products=products, tflops=_tflops(flop, row["ms"]),
               graph_tflops=_tflops(flop, row["graph_ms"]),
               share=row["bound_ms"] / row["ms"],
               graph_share=row["bound_ms"] / row["graph_ms"])
    return row


def describe(row: dict) -> str:
    """One line of a ``measure`` row."""
    tf32 = " TF32" if row["precision"] == "default" else " f32"
    return (f"h={row['h']:3d} N={row['n']} dots={row['n_dots']} "
            f"{row['precision']}: kernel {row['ms']:.4f} ms per call "
            f"({row['graph_ms']:.4f} ms from a CUDA graph; "
            f"{row['tflops']:.2f} / {row['graph_tflops']:.2f} TFLOP/s of "
            f"the {row['products']} products it runs), bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({100 * row['share']:.1f}% of it per call, "
            f"{100 * row['graph_share']:.1f}% from the graph); plain "
            f"bdot_ref {row['plain_ms']:.4f} ms; "
            f"torch.linalg.matrix_power{tf32} {row['library_ms']:.4f} ms")


def run(device="cuda") -> Dict[str, List[dict]]:
    """Measure and print; returns {"bdot": rows by h and precision,
    "solver": rows by product shape}. Each ``bdot`` call here is a
    kernel launch and adds to ``bdot_op.LAUNCHES``."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe measures the GPU; give a CUDA device")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = []
    for h in SIZES:
        x = torch.randn((N, h, h), generator=gen, device=device) * 0.1
        for precision in bdot_op.PASSES:
            rows.append(measure(x, precision))
            print(f"[probe bdot] {describe(rows[-1])}", flush=True)

    solver = []
    for (sa, sb), count in sorted(
            solver_product_shapes(SOLVER_N, 512, device).items()):
        a = torch.randn(sa, generator=gen, device=device)
        b = torch.randn(sb, generator=gen, device=device)
        ms = probes.cuda_ms(lambda: torch.matmul(a, b))
        flop = 2.0 * sa[0] * sa[1] * sa[2] * sb[-1]
        solver.append(dict(a=list(sa), b=list(sb), count=count, ms=ms,
                           tflops=_tflops(flop, ms)))
        print(f"[probe bdot] spd_solve [{SOLVER_N}, 512, 512] product "
              f"{list(sa)} @ {list(sb)} x{count}: torch.matmul f32 "
              f"{ms:.4f} ms ({_tflops(flop, ms):.2f} TFLOP/s)", flush=True)
    return {"bdot": rows, "solver": solver}


def ptxas_report() -> List[str]:
    """``nvcc -Xptxas -v`` of the kernel's source, a line per
    instantiation ``bdot_kernel<h, passes>``."""
    return probes.ptxas_report(bdot_op._SRC, r"bdot_kernel")


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
