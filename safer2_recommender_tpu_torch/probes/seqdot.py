"""What one step of a chain of dependent d x d products costs on the GPU
(the counterpart of the JAX package's ``scripts/probe_seqdot.py``, which
asked the same of XLA on a TPU). Chained small products are the backbone
of Newton-Schulz, subspace iteration and the blocked products around the
inverse-Cholesky kernel.

    python -m safer2_recommender_tpu_torch.probes.seqdot

For d = 256 and 512, from the script's input x0 = 0.001 N(0, 1) (drawn
from ``np.random.default_rng(0)``, d = 256 first), each chain x <- f(x):

- ``seq x@x``: f(x) = (x @ x) * 0.999 at ``"highest"`` (float32) and at
  ``"high"`` (TF32, the port's name for JAX's DEFAULT precision);
- ``seq batched[8] x@x``: the same on 8 stacked copies, one batched
  product a step, at ``"highest"``;
- ``8 indep dots/iter``: f(x) = sum_i (x (1 + 1e-6 i)) @ x * 0.999 / 8,
  eight products a step that do not depend on each other.

Each step's time is device time per step: a CUDA graph of k dependent
steps, replayed at k = 16 and 128, differenced (the script's scan-length
differencing, without the host's launches). Printed as us per step and
TFLOP/s beside the bound (x read and written once against 2 d^3 FLOPs a
product at 67 TFLOP/s in float32, 495 in TF32). The chain underflows to
exact zeros within five steps at both d, as the script's does; only its
first three products are checked, against a float64 chain on the card
(``REL_TOL``). A machine without CUDA is an error.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.utils.device import matmul_precision

DS = (256, 512)
SCALE = 0.999
BATCH = 8          # chains of the batched variant
INDEP = 8          # products a step of the independent variant
CHECK_STEPS = 3
REL_TOL = {"highest": 1e-4, "high": 1e-2}   # of each step, vs float64


def draws(ds=DS) -> Dict[int, np.ndarray]:
    """The script's N(0, 1) draws, float32, at each d in its order (x0
    is 0.001 times each, on the device: ``start``)."""
    rng = np.random.default_rng(0)
    return {d: rng.normal(size=(d, d)).astype(np.float32) for d in ds}


def start(draw: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(draw).to(device) * 0.001


def seq_step(x: torch.Tensor) -> torch.Tensor:
    return (x @ x) * SCALE


def indep_step(x: torch.Tensor) -> torch.Tensor:
    return sum((x * (1.0 + 1e-6 * i)) @ x for i in range(INDEP)) * (
        SCALE / INDEP)


class Variant(NamedTuple):
    name: str
    precision: str          # torch.set_float32_matmul_precision's word
    step: Callable
    batch: int              # chains stacked in x
    products: int           # d x d products a step


VARIANTS = (
    Variant("seq x@x", "highest", seq_step, 1, 1),
    Variant("seq x@x", "high", seq_step, 1, 1),
    Variant(f"seq batched[{BATCH}] x@x", "highest", seq_step, BATCH, BATCH),
    Variant(f"{INDEP} indep dots/iter", "highest", indep_step, 1, INDEP),
)


def initial(v: Variant, x0: torch.Tensor) -> torch.Tensor:
    return x0 if v.batch == 1 else torch.stack([x0] * v.batch)


def chain(step: Callable, x: torch.Tensor, steps: int) -> List[torch.Tensor]:
    """x after each of the first ``steps`` steps."""
    out = []
    for _ in range(steps):
        x = step(x)
        out.append(x)
    return out


def step_errors(v: Variant, x0: torch.Tensor) -> List[float]:
    """Relative Frobenius error of each of the first ``CHECK_STEPS``
    steps at ``v``'s precision against the float64 chain."""
    x = initial(v, x0)
    with matmul_precision(v.precision):
        got = chain(v.step, x, CHECK_STEPS)
    want = chain(v.step, x.double(), CHECK_STEPS)
    return [float(torch.linalg.norm(g.double() - w) / torch.linalg.norm(w))
            for g, w in zip(got, want)]


def bound(v: Variant, d: int) -> dict:
    rate = (probes.F32_FLOP_PER_S if v.precision == "highest"
            else probes.TF32_TENSOR_FLOP_PER_S)
    return probes.bound(2 * 4 * v.batch * d * d, 2.0 * v.products * d ** 3,
                        rate)


def run(device="cuda") -> List[dict]:
    """One row per d and variant on ``device`` (a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the seqdot probe measures a CUDA device, not "
                         f"{device}")
    rows = []
    for d, draw in draws().items():
        x0 = start(draw, device)
        for v in VARIANTS:
            with matmul_precision(v.precision):
                ms = probes.chain_ms(v.step, initial(v, x0))
                zeros = bool((chain(v.step, initial(v, x0), 5)[-1] == 0)
                             .all())
            flop = 2.0 * v.products * d ** 3
            rows.append(dict(d=d, name=v.name, precision=v.precision,
                             us=ms * 1e3, tflops=flop / (ms * 1e-3) / 1e12,
                             errors=step_errors(v, x0),
                             tol=REL_TOL[v.precision], zero_by_5=zeros,
                             **bound(v, d)))
    return rows


def describe(row: dict) -> str:
    return (f"d={row['d']} {row['precision']:8s} {row['name']:22s} "
            f"{row['us']:8.2f} us/iter ({row['tflops']:6.2f} TFLOP/s), bound "
            f"{row['bound_ms'] * 1e3:.3f} us by {row['bound_by']} "
            f"({100 * row['bound_ms'] / (row['us'] * 1e-3):.1f}%); first "
            f"{CHECK_STEPS} steps vs float64 rel err "
            + ", ".join(f"{e:.1e}" for e in row["errors"])
            + f" (tol {row['tol']:g}); exact zeros by step 5: "
            f"{row['zero_by_5']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    print(probes.nvidia_smi(), flush=True)
    rows = run()
    for row in rows:
        print(describe(row), flush=True)
    return 0 if all(max(r["errors"]) <= r["tol"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
