"""The inverse-Cholesky kernel on the GPU: its checks, and its times
beside its bound, its plain version and the nearest library calls.

    python -m safer2_recommender_tpu_torch.probes.chol_inverse

For r = 8/16/32/64 it holds ``block_chol.chol_inverse_small`` against
``chol_inverse_small_ref`` at N = 4096 and at the ragged N (0, 1, the
systems of one block +/- 1, 4097), each batch with the hard cases: an
all-zero system with a unit ridge (must give the identity) and a
rank-deficient one with ridge 1e-2. Then it times each r at N = 4096 in
turns (each callable once in order, then once in reverse; the better
of each pair): the kernel, the plain version, the library pair
``torch.linalg.cholesky_ex`` + ``solve_triangular`` (no single PyTorch
call computes ``inv(chol(.))``; the port never calls either), and
``cholesky_ex`` alone. Times are CUDA events after warm-up; a machine
without CUDA is an error. ``chip_smoke.py`` runs the same checks and
times, and adds the shapes the main path gives the kernel.

The bound is the least time the card could take: the larger of the
bytes the function needs (the lower triangle of a and the ridge read
once, the whole of out written once) over 3.35 TB/s and its FLOPs
(2 r^3 / 3 per system: r^3 / 3 for the factor, as many for its
inverse) over 67 TFLOP/s, the H100 SXM's f32 rate outside the tensor
cores, both at its 700 W limit.
"""

from __future__ import annotations

import sys
from typing import List

import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.ops import block_chol

N_FULL = 4096
WARP_BLOCK = 128    # threads per block of the r <= 32 kernel


def bound(n: int, r: int) -> dict:
    """Least time of ``inv(chol(.))`` over n systems of size r: the
    kernel reads only the lower triangle of each system."""
    return probes.bound(4 * n * (r * (r + 1) // 2 + r + r * r),
                       n * 2 * r ** 3 / 3)


def spd_batch(gen, n: int, r: int, device):
    """Well-conditioned SPD systems X X^T / (2r) + 0.1 I and ridges."""
    x = torch.randn((n, r, 2 * r), generator=gen, device=device)
    a = x @ x.transpose(1, 2) / (2 * r) + 0.1 * torch.eye(r, device=device)
    ridge = torch.rand((n, r), generator=gen, device=device) * 0.49 + 0.01
    return a, ridge


def hard_batch(gen, n: int, r: int, device):
    """``spd_batch`` with system 0 all zero under a unit ridge and system
    1 of rank r/2 under ridge 1e-2 (where n reaches them)."""
    a, ridge = spd_batch(gen, n, r, device)
    if n > 0:
        a[0] = 0.0
        ridge[0] = 1.0
    if n > 1:
        y = torch.randn((r, r // 2), generator=gen, device=device)
        a[1] = y @ y.T / r
        ridge[1] = 1e-2
    return a.contiguous(), ridge.contiguous()


def errors(got: torch.Tensor, want: torch.Tensor, hard: bool = True) -> dict:
    """Kernel against plain on a ``hard_batch`` (or, ``hard=False``, an
    ``spd_batch``): the largest absolute error, the largest relative
    error (of each system's max|plain|) of the well-conditioned systems
    and of the rank-deficient one, system 0's distance from the
    identity, and whether every entry above the diagonal is exactly
    zero."""
    n, r, _ = got.shape
    first = 2 if hard else 0
    rel = ((got - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)).clamp_min(1e-30))
    eye = torch.eye(r, device=got.device)
    upper = torch.triu(torch.ones(r, r, dtype=torch.bool,
                                  device=got.device), 1)
    return {
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": float((got - want).abs().max()) if n else 0.0,
        "max_rel_err": float(rel[first:].max()) if n > first else 0.0,
        "rank_def_rel_err": float(rel[1]) if n > 1 else 0.0,
        "eye_err": float((got[0] - eye).abs().max()) if n else 0.0,
        "upper_zero": bool((got[:, upper] == 0).all()),
    }


def ragged_sizes(r: int):
    """N = 0, 1, the systems of one block +/- 1, and 4097."""
    per_block = WARP_BLOCK // r if r <= 32 else 1
    return sorted({0, 1, max(per_block - 1, 0), per_block + 1, 4097})


def library_pair(a: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """``inv(chol(a + diag(ridge)))`` in two library calls."""
    eye = torch.eye(a.shape[1], device=a.device).expand_as(a)
    low, _ = torch.linalg.cholesky_ex(a + torch.diag_embed(ridge))
    return torch.linalg.solve_triangular(low, eye, upper=False)


def measure(a: torch.Tensor, ridge: torch.Tensor) -> dict:
    """Times at one shape in turns, with the bound and its share: the
    kernel per call through its wrapper (``ms``) and from a CUDA graph
    (``device_ms``), the plain version, the library pair and
    cholesky_ex alone."""
    fns = {
        "plain_ms": lambda: block_chol.chol_inverse_small_ref(a, ridge),
        "library_ms": lambda: library_pair(a, ridge),
        "cholesky_ex_ms": lambda: torch.linalg.cholesky_ex(
            a + torch.diag_embed(ridge)),
    }
    fns["ms"] = lambda: block_chol.chol_inverse_small(a, ridge)
    row = probes.in_turns(fns)
    row["device_ms"] = probes.graph_ms(fns["ms"])
    n, r = a.shape[0], a.shape[1]
    row.update(bound(n, r))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["device_bound_share"] = row["bound_ms"] / row["device_ms"]
    row["shape"] = [n, r, r]
    return row


def ptxas_report() -> List[str]:
    """``nvcc -Xptxas -v`` of the kernel's source, a line per kernel."""
    return probes.ptxas_report(block_chol._SRC,
                               r"chol_inverse_(?:warp|block\d+)_kernel")


def check_r(r: int, device, gen) -> dict:
    """The kernel against the plain version at N = 4096 and the ragged
    N; the worst of each error over those batches."""
    worst = {"finite": True, "upper_zero": True, "max_abs_err": 0.0,
             "max_rel_err": 0.0, "rank_def_rel_err": 0.0, "eye_err": 0.0}
    sizes = [N_FULL] + ragged_sizes(r)
    for n in sizes:
        a, ridge = hard_batch(gen, n, r, device)
        got = block_chol.chol_inverse_small(a, ridge)
        want = block_chol.chol_inverse_small_ref(a, ridge)
        torch.cuda.synchronize()
        e = errors(got, want)
        for k, v in e.items():
            worst[k] = (worst[k] and v) if isinstance(v, bool) else max(
                worst[k], v)
    worst["n_checked"] = sizes
    return worst


def run(device="cuda") -> dict:
    """Check and time every r at N = 4096; returns {r: row}, each row
    ``check_r``'s worst errors and ``measure``'s times."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe measures the GPU; give a CUDA device")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rows = {}
    for r in block_chol.KERNEL_SIZES:
        row = check_r(r, device, gen)
        a, ridge = spd_batch(gen, N_FULL, r, device)
        row.update(measure(a, ridge))
        rows[r] = row
        print(f"[probe chol_inverse] {describe(row)}", flush=True)
    return rows


def describe(row: dict) -> str:
    """One line of a ``measure`` row (and ``check_r`` errors if any)."""
    parts = [f"{row['shape']}: kernel {row['ms']:.4f} ms per call "
             f"({row['device_ms']:.4f} ms from a CUDA graph), bound "
             f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
             f"({100 * row['bound_share']:.1f}% of it per call, "
             f"{100 * row['device_bound_share']:.1f}% from the graph)"]
    parts.append(f"plain {row['plain_ms']:.4f} ms, library cholesky_ex + "
                 f"solve_triangular {row['library_ms']:.4f} ms, cholesky_ex "
                 f"alone {row['cholesky_ex_ms']:.4f} ms")
    if "rank_def_rel_err" in row:
        parts.append(f"max rel err {row['max_rel_err']:.2e}, rank-deficient "
                     f"{row['rank_def_rel_err']:.2e}, identity "
                     f"{row['eye_err']:.1e}, zero above the diagonal "
                     f"{row['upper_zero']}")
    return "; ".join(parts)


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
