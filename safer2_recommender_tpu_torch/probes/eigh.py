"""The shared Gramian's eigendecomposition on the GPU: cuSOLVER's eigh at
512 and by size and batch, the matmul-only alternative, and the port's
warm-started refresh (the counterpart of the JAX package's
``scripts/probe_eigh.py`` and ``scripts/probe_eigh2.py``, which asked the
same of XLA on a TPU).

    python -m safer2_recommender_tpu_torch.probes.eigh \
        [--part shared|sizes|route|all|refresh]

Inputs are the scripts', drawn from ``np.random.default_rng(0)`` in
their order and at their sizes. ``shared`` (``probe_eigh.py``): the
Gramian G = V^T V of 40,000 x 512 rows V with a decaying column scale,
formed in float64 on the host (NumPy 2 promotes the script's float32
draws divided by ``np.sqrt(D)`` to float64) and rounded to float32 on
the way to the card, as ``jnp.asarray`` rounds it; in the script's
order:

- ``torch.linalg.eigh`` of G and of the [2, 512, 512] stack [G, 1.1 G],
  per call, and the relative error of Q diag(w) Q^T against G;
- 30 Newton-Schulz iterations x <- 1.5 x - 0.5 x x x from G / ||G||,
  per iteration from CUDA graphs of dependent iterations (differenced at
  two lengths), with TFLOP/s;
- a 1% drift G2 of G: the off-diagonal share of Q^T G2 Q in the old
  basis, and the error of keeping the old basis;
- the port's own ``woodbury.refresh_eigh`` on G2 from G's basis at the
  JAX package's tolerance (``config.JAX_EIG_REFRESH_TOL``, 0.08: the
  warm branch the script timed; the port's default, 0, takes a full
  eigh): the branch it took (``SOLVE_PATHS``), its reconstruction
  error, and its ms per call beside a cold eigh of G2.

``sizes`` (``probe_eigh2.py``): ``torch.linalg.eigh`` of random Gramians
at each (batch, d) of ``SIZES``, per call beside one matrix of the batch
alone, and the error of each.

``route``: the port's own eigendecomposition, ``woodbury.sym_eigh``, at
every shape the epochs give it (``ROUTE_SHAPES``: the cold 128, 256 and
512, the warm refresh's [d / 128, 128, 128] blocks, ``block_eigh``'s
[8, 64, 64] and [16, 32, 32] at dim 512 and [2, 32, 32] at dim 64), on
random Gramians drawn as ``sizes`` draws them (seed 1), beside each
candidate route of ``CANDIDATES``: float32 ``torch.linalg.eigh``,
float64 rounded, float32 by ``syevd`` (the matrix padded to 513 with a
diagonal above its spectrum, where torch leaves Jacobi; no process-wide
setting) and float32 polished by one float64 Rayleigh-Ritz step.

eigh reads the host after each call (torch checks cuSOLVER's ``info``),
so it is timed per call by CUDA events after a warm-up, that read
included (the host reads of one call are counted), and never from a
graph. Each eigh row names the device kernels that one call ran (the
cuSOLVER route) and its bound: 2 d^2 x 4 bytes against 9 d^3 FLOPs a
matrix (the symmetric QR algorithm with vectors, Golub and Van Loan) at
67 TFLOP/s. Each row decomposes its input three ways: float32
``torch.linalg.eigh`` (cuSOLVER's float32 route for 32 <= d <= 512 is
Jacobi, ``syevj``, whose eigenvectors are orthogonal only to ~1e-3 at
d = 512: ``orth``, ||Q^T Q - I||_F), float64 on the card rounded to
float32, and the port's ``woodbury.sym_eigh``. Every product runs at
``"highest"`` (float32, no TF32). A reading that is not finite fails,
as does a reconstruction of the float64 route or of the port's above
``RECON_TOL``, or the port's orthogonality above ``ORTH_TOL``; the
float32 call is a reading. A machine without CUDA is an error.

``refresh`` (``probes/refresh.py``, not part of ``all``): the next
epoch of ML-1M, the 50k set and the full synthetic MSD set at dim 512,
from one trained state, at the JAX package's tolerance and at the
port's default, side by side.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
from safer2_recommender_tpu_torch.ops import woodbury
from safer2_recommender_tpu_torch.utils.device import matmul_precision

PARTS = ("shared", "sizes", "route")
D = 512
GRAM_ROWS = 40_000
NS_ITERS = 30
SIZES = ((1, 512), (2, 512), (1, 256), (2, 256), (4, 256), (1, 128),
         (4, 128), (8, 128), (8, 64), (16, 64), (16, 32))
# the shapes the epochs decompose: (batch, d), batch 1 a single matrix
ROUTE_SHAPES = ((1, 128), (1, 256), (1, 512), (2, 128), (4, 128),
                (8, 64), (16, 32), (2, 32))
# calls timed per candidate route (the padded syevd is slow at small d)
ROUTE_ITERS = 5
# Reconstruction error ||Q diag(w) Q^T - G|| / ||G|| of an exact float32
# eigendecomposition (LAPACK's on the CPU, the card's float64 route
# rounded), the JAX package's bound on a cold eigh
# (tests/test_torch_woodbury.py), and the orthogonality ||Q^T Q - I||_F
# the port's route is held to (float64 rounded sits near 1e-6; the
# card's float32 Jacobi read 2.1e-3 at 512, PERF.md)
RECON_TOL = 1e-5
ORTH_TOL = 1e-4


def shared_inputs(d: int = D, rows: int = GRAM_ROWS
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``probe_eigh.py``'s G and the drift added to it, each rounded to
    float32 from its float64 product as ``jnp.asarray`` rounds it; G2 is
    then ``G + drift``, symmetrized, on the device (``drifted``)."""
    rng = np.random.default_rng(0)
    # float64 from here, as NumPy 2 promotes the script's float32 / sqrt
    v = rng.normal(size=(rows, d)).astype(np.float32).astype(
        np.float64) / np.sqrt(d)
    v *= (1.0 / np.sqrt(np.arange(1, d + 1)))[None, :] * 3
    g = (v.T @ v).astype(np.float32)
    drift = 0.01 * (v.T @ (v * rng.normal(size=(rows, 1)).astype(
        np.float32) * 0.05))
    return g, drift.astype(np.float32)


def drifted(g: torch.Tensor, drift: torch.Tensor) -> torch.Tensor:
    g2 = g + drift
    return 0.5 * (g2 + g2.T)


def sizes_inputs() -> List[Tuple[int, int, np.ndarray]]:
    """``probe_eigh2.py``'s Gramians: (batch, d, float32 [batch, d, d],
    or [d, d] at batch 1) in ``SIZES``' order."""
    rng = np.random.default_rng(0)
    out = []
    for batch, d in SIZES:
        a = rng.normal(size=(batch, d, d)).astype(np.float32)
        g = np.einsum("nab,ncb->nac", a, a) / d
        out.append((batch, d, g if batch > 1 else g[0]))
    return out


def reconstruction_error(w: torch.Tensor, q: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """||Q diag(w) Q^T - G||_F / ||G||_F, per matrix of a batch."""
    with matmul_precision("highest"):
        r = (q * w[..., None, :]) @ q.mT
    return (torch.linalg.norm(r - g, dim=(-2, -1))
            / torch.linalg.norm(g, dim=(-2, -1)))


def ns_step(x: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz iteration, ``probe_eigh.py``'s body."""
    return 1.5 * x - 0.5 * ((x @ x) @ x)


def newton_schulz(g: torch.Tensor) -> torch.Tensor:
    """``NS_ITERS`` iterations from G / ||G||."""
    x = g / torch.linalg.norm(g)
    for _ in range(NS_ITERS):
        x = ns_step(x)
    return x


def drift_readings(q: torch.Tensor, g2: torch.Tensor) -> Dict[str, float]:
    """In G's basis ``q``: ||offdiag(B)|| / ||B|| of B = Q^T G2 Q, and the
    error of Q diag(B) Q^T (the stale basis) against G2."""
    with matmul_precision("highest"):
        b = q.T @ g2 @ q
        diag = torch.diagonal(b)
        off = b - torch.diag(diag)
        stale = (q * diag) @ q.T
    return {"offdiag_share": float(torch.linalg.norm(off)
                                   / torch.linalg.norm(b)),
            "stale_error": float(torch.linalg.norm(stale - g2)
                                 / torch.linalg.norm(g2))}


def refresh(g2: torch.Tensor, q: torch.Tensor,
            tol: float) -> Tuple[str, torch.Tensor, torch.Tensor]:
    """``woodbury.refresh_eigh(g2, q, tol)``: (the branch it took,
    "warm" or "cold", Q, lam)."""
    warm = woodbury.SOLVE_PATHS["refresh_warm"]
    with matmul_precision("highest"):
        q2, lam = woodbury.refresh_eigh(g2, q, tol)
    return ("warm" if woodbury.SOLVE_PATHS["refresh_warm"] > warm
            else "cold"), q2, lam


def eigh_bound(batch: int, d: int) -> dict:
    return probes.bound(batch * 4 * (2 * d * d + d), batch * 9.0 * d ** 3)


def orthogonality(q: torch.Tensor) -> float:
    """max over a batch of ||Q^T Q - I||_F, in float64."""
    q = q.double()
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return float(torch.linalg.norm(q.mT @ q - eye, dim=(-2, -1)).max())


def _syevd_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 eigh by cuSOLVER's ``syevd``: ``x`` padded to 513 with a
    diagonal above its spectrum (torch takes Jacobi at 32 <= d <= 512 in
    float32), its d lowest pairs kept."""
    d, n = x.shape[-1], max(x.shape[-1] + 1, 513)
    top = torch.linalg.norm(x, dim=(-2, -1)) * 2 + 1
    pad = torch.zeros(x.shape[:-2] + (n, n), dtype=x.dtype, device=x.device)
    pad[..., :d, :d] = x
    idx = torch.arange(d, n, device=x.device)
    pad[..., idx, idx] = top[..., None]
    w, q = torch.linalg.eigh(pad)
    return w[..., :d], q[..., :d, :d].contiguous()


def _rayleigh_ritz(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 eigh, then one Rayleigh-Ritz step in float64 on its basis
    made orthonormal: the eigendecomposition of Q^T X Q, rotated back."""
    q = torch.linalg.qr(torch.linalg.eigh(x)[1].double()).Q
    with matmul_precision("highest"):
        b = q.mT @ x.double() @ q
        w, v = torch.linalg.eigh(0.5 * (b + b.mT))
        q = q @ v
    return w.float(), q.float()


def _f64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    w, q = torch.linalg.eigh(x.double())
    return w.float(), q.float()


CANDIDATES = {"float32": torch.linalg.eigh, "float64": _f64,
              "float32 syevd": _syevd_f32,
              "float32 + Rayleigh-Ritz": _rayleigh_ritz}


def _readings(fn, x: torch.Tensor, iters: int = 20) -> dict:
    """ms per call (mean of ``iters``), reconstruction error and
    orthogonality of ``fn(x)``, whether its eigenvalues ascend and
    whether its result is finite."""
    ms = probes.cuda_ms(lambda: fn(x), iters=iters)
    w, q = fn(x)
    err = reconstruction_error(w, q, x).reshape(-1)
    return dict(ms=ms, error=float(err.max()), orth=orthogonality(q),
                ascending=bool((w[..., 1:] >= w[..., :-1]).all()),
                finite=bool(torch.isfinite(w).all() and torch.isfinite(q).all()
                            and torch.isfinite(err).all()))


def _eigh_row(name: str, x: torch.Tensor, single_ms=None) -> dict:
    """Time, host reads, kernels and bound of float32 eigh of ``x``, and
    the ms, errors and orthogonality of it, of the float64 route rounded
    and of the port's ``woodbury.sym_eigh``."""
    fn = lambda: torch.linalg.eigh(x)  # noqa: E731
    f32, f64 = _readings(torch.linalg.eigh, x), _readings(_f64, x)
    route = _readings(woodbury.sym_eigh, x)
    batch = 1 if x.dim() == 2 else x.shape[0]
    d = x.shape[-1]
    row = dict(name=name, batch=batch, d=d, ms=f32["ms"],
               host_reads=probes.host_reads(fn),
               kernels=probes.kernel_names(fn), error=f32["error"],
               orth=f32["orth"], f64_ms=f64["ms"], error_f64=f64["error"],
               orth_f64=f64["orth"], route_ms=route["ms"],
               error_route=route["error"], orth_route=route["orth"],
               finite=f32["finite"] and f64["finite"] and route["finite"],
               **eigh_bound(batch, d))
    if single_ms is not None:
        row["single_ms"] = single_ms
    return row


def eigh_ok(row: dict) -> bool:
    """The row's checks: finite; the float64 route and the port's
    within ``RECON_TOL``, the port's orthogonal within ``ORTH_TOL``."""
    return (row["finite"] and row["error_f64"] <= RECON_TOL
            and row["error_route"] <= RECON_TOL
            and row["orth_route"] <= ORTH_TOL)


def _shared(device) -> dict:
    g_host, drift_host = shared_inputs()
    g = torch.from_numpy(g_host).to(device)
    rows = [_eigh_row(f"eigh {D}", g),
            _eigh_row(f"eigh [2,{D}]", torch.stack([g, g * 1.1]))]
    with matmul_precision("highest"):
        x = g / torch.linalg.norm(g)
        per_iter = probes.chain_ms(ns_step, x)
        ns = newton_schulz(g)
    ns_ms = NS_ITERS * per_iter
    flop = NS_ITERS * 2 * 2 * D ** 3
    newton = dict(ms=ns_ms, iters=NS_ITERS, tflops=flop / (ns_ms * 1e-3)
                  / 1e12, finite=bool(torch.isfinite(ns).all()),
                  **probes.bound(NS_ITERS * 2 * 4 * D * D, flop))

    w, q = woodbury.sym_eigh(g)
    g2 = drifted(g, torch.from_numpy(drift_host).to(device))
    drift = drift_readings(q, g2)
    tol = JAX_EIG_REFRESH_TOL
    branch, q2, lam2 = refresh(g2, q, tol)
    times = probes.in_turns({
        "refresh_eigh": lambda: refresh(g2, q, tol),
        "cold eigh": lambda: woodbury.sym_eigh(g2)})
    current = dict(branch=branch, tol=tol, ms=times["refresh_eigh"],
                   cold_ms=times["cold eigh"],
                   error=float(reconstruction_error(lam2, q2, g2)))
    return dict(eigh=rows, newton_schulz=newton, drift=drift,
                refresh=current)


def _sizes(device) -> List[dict]:
    rows = []
    for batch, d, g in sizes_inputs():
        x = torch.from_numpy(g).to(device)
        single = None
        if batch > 1:
            one = x[0].contiguous()
            single = probes.cuda_ms(lambda: torch.linalg.eigh(one))
        rows.append(_eigh_row(f"eigh[{batch:2d},{d:3d}]", x, single))
    return rows


def route_inputs() -> List[Tuple[int, int, np.ndarray]]:
    """Random Gramians at ``ROUTE_SHAPES``, drawn as ``sizes_inputs``
    draws its own, from ``np.random.default_rng(1)``."""
    rng = np.random.default_rng(1)
    out = []
    for batch, d in ROUTE_SHAPES:
        a = rng.normal(size=(batch, d, d)).astype(np.float32)
        g = np.einsum("nab,ncb->nac", a, a) / d
        out.append((batch, d, g if batch > 1 else g[0]))
    return out


def route_ok(row: dict) -> bool:
    """The port's route at one shape: finite, ascending, within
    ``RECON_TOL`` and ``ORTH_TOL``."""
    r = row["route"]
    return (r["finite"] and r["ascending"] and r["error"] <= RECON_TOL
            and r["orth"] <= ORTH_TOL)


def _route(device) -> List[dict]:
    rows = []
    for batch, d, g in route_inputs():
        x = torch.from_numpy(g).to(device)
        rows.append(dict(batch=batch, d=d,
                         route=_readings(woodbury.sym_eigh, x),
                         candidates={k: _readings(fn, x, ROUTE_ITERS)
                                     for k, fn in CANDIDATES.items()}))
    return rows


def run(device="cuda", parts=PARTS) -> dict:
    """Measure ``parts`` on ``device`` (a CUDA device): {"shared":
    {...}, "sizes": [rows]} for the parts asked."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the eigh probe measures a CUDA device, not "
                         f"{device}")
    out = {}
    if "shared" in parts:
        out["shared"] = _shared(device)
    if "sizes" in parts:
        out["sizes"] = _sizes(device)
    if "route" in parts:
        out["route"] = _route(device)
    return out


def eigh_rows(res: dict) -> List[dict]:
    """Every eigh row of a ``run`` result."""
    return res.get("shared", {}).get("eigh", []) + res.get("sizes", [])


def describe_eigh(row: dict) -> str:
    line = (f"{row['name']}: {row['ms']:.4f} ms per call (its "
            f"{row['host_reads']} host read(s) included)")
    if "single_ms" in row:
        ratio = row["ms"] / (row["batch"] * row["single_ms"])
        line += (f", one matrix alone {row['single_ms']:.4f} ms, batch / "
                 f"(batch x one) {ratio:.2f}"
                 + (" (the batch costs more than its matrices alone)"
                    if ratio > 1 else ""))
    return (line + f"; bound {row['bound_ms']:.5f} ms by {row['bound_by']}"
            f" ({100 * row['bound_ms'] / row['ms']:.2f}%); reconstruction "
            f"rel err {row['error']:.2e}, orth {row['orth']:.2e}; float64 "
            f"route {row['f64_ms']:.4f} ms, rel err {row['error_f64']:.2e} "
            f"(tol {RECON_TOL:g}), orth {row['orth_f64']:.2e}; the port's "
            f"sym_eigh {row['route_ms']:.4f} ms, rel err "
            f"{row['error_route']:.2e} (tol {RECON_TOL:g}), orth "
            f"{row['orth_route']:.2e} (tol {ORTH_TOL:g}); kernels: "
            + probes.describe_kernels(row["kernels"], 3))


def describe_route(row: dict) -> str:
    """One shape of the ``route`` part: the port's route, then each
    candidate, ms / rel err / orth."""
    def one(r):
        return (f"{r['ms']:.4f} ms, rel err {r['error']:.2e}, orth "
                f"{r['orth']:.2e}" + ("" if r["finite"] else ", NOT FINITE"))

    return (f"route [{row['batch']:2d},{row['d']:3d}]: sym_eigh "
            + one(row["route"]) + f" (tol {RECON_TOL:g}, {ORTH_TOL:g}); "
            + "; ".join(f"{k} {one(r)}" for k, r in row["candidates"].items()))


def describe(res: dict) -> List[str]:
    lines = []
    if "shared" in res:
        s = res["shared"]
        ns, dr, cur = s["newton_schulz"], s["drift"], s["refresh"]
        lines += [describe_eigh(row) for row in s["eigh"]] + [
            f"{ns['iters']} Newton-Schulz {D}-matmul iterations: "
            f"{ns['ms']:.4f} ms (~{ns['tflops']:.1f} TFLOP/s; per iteration "
            f"from CUDA graphs of dependent iterations), bound "
            f"{ns['bound_ms']:.4f} ms by {ns['bound_by']}",
            f"after 1%-drift: offdiag/diag = {dr['offdiag_share']:.2e}; "
            f"stale-basis recon rel err: {dr['stale_error']:.2e}",
            f"refresh_eigh (current) on the drifted G from the cold basis at "
            f"tol {cur['tol']}: {cur['branch']} branch, {cur['ms']:.4f} ms "
            f"per call beside cold eigh {cur['cold_ms']:.4f} ms; recon rel "
            f"err {cur['error']:.2e}"]
    lines += [describe_eigh(row) for row in res.get("sizes", [])]
    lines += [describe_route(row) for row in res.get("route", [])]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=PARTS + ("all", "refresh"),
                    default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    print(probes.nvidia_smi(), flush=True)
    if args.part == "refresh":
        from safer2_recommender_tpu_torch.probes import refresh

        rows = refresh.run()
        for row in rows:
            for line in refresh.describe(row):
                print(line, flush=True)
        bad = [b for row in rows for b in refresh.check(row)]
        for b in bad:
            print("FAILED: " + b, flush=True)
        return 1 if bad else 0
    res = run(parts=PARTS if args.part == "all" else (args.part,))
    for line in describe(res):
        print(line, flush=True)
    return 0 if (all(map(eigh_ok, eigh_rows(res)))
                 and all(map(route_ok, res.get("route", [])))) else 1


if __name__ == "__main__":
    sys.exit(main())
