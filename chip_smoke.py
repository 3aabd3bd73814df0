#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (safer2_recommender_tpu_torch)
on one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one line to stdout:
  1. device: requires CUDA, turns TF32 off, prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the inverse-Cholesky kernel from csrc/ (sm_90a);
  3. kernel: compares the kernel with its plain torch version on the
     card at r = 8/16/32/64, N = 4096 (random SPD systems plus an
     all-zero system with a unit ridge and a rank-deficient one), times
     both with CUDA events, and checks spd_solve against a float64
     torch.linalg.solve at d = 8/32/64/128/512;
  4. train: the port's CLI in-process, SAFER2 on the bundled ML-1M split
     at the README's dim-32 config for 10 epochs; NDCG@20 >= 0.2 and
     mean dual weight within alpha +/- 0.02 after every epoch;
  5. dim 64: the same run at dim 64 for 3 epochs (the r = 64 kernel
     path); finite tables and the dual-weight gate;
  6. serve: 3 recommend() batches of 256 held-out users from the dim-32
     model; ids in range and outside each user's history.
Then a JSON line describing the kernel (launch count on the main path,
errors, times) and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the script exits nonzero and never prints the last
line. Without CUDA, or without the package beside it, it exits 1.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ML1M = os.path.join(ROOT, "tests", "ml-1m")
REL_TOL = 1e-4          # kernel vs plain, well-conditioned systems
REL_TOL_RANK_DEF = 1e-3  # the rank-deficient system (ridge 1e-2)
SOLVE_RTOL, SOLVE_ATOL = 2e-3, 2e-4   # the JAX package's spd_solve bounds
NDCG20_MIN = 0.2
ALPHA = 0.3
DUAL_TOL = 0.02
README_ARGS = ["--model_name", "safer2", "--uobs_weight", "0.004",
               "--l2_reg", "0.004", "--alpha", str(ALPHA),
               "--bandwidth", "0.15"]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def spd_batch(gen, n: int, r: int, device):
    """Well-conditioned SPD systems X X^T / (2r) + 0.1 I and ridges."""
    import torch

    x = torch.randn((n, r, 2 * r), generator=gen, device=device)
    a = x @ x.transpose(1, 2) / (2 * r) + 0.1 * torch.eye(r, device=device)
    ridge = torch.rand((n, r), generator=gen, device=device) * 0.49 + 0.01
    return a, ridge


def phase_kernel(block_chol, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n = 4096
    by_r = {}
    for r in block_chol.KERNEL_SIZES:
        a, ridge = spd_batch(gen, n, r, device)
        a[0] = 0.0                      # all-zero system, unit ridge
        ridge[0] = 1.0
        y = torch.randn((r, r // 2), generator=gen, device=device)
        a[1] = y @ y.T / r              # rank r/2, small ridge
        ridge[1] = 1e-2
        a, ridge = a.contiguous(), ridge.contiguous()
        got = block_chol.chol_inverse_small(a, ridge)
        want = block_chol.chol_inverse_small_ref(a, ridge)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"r={r}: nonfinite output")
        diff = (got - want).abs().amax(dim=(1, 2))
        scale = want.abs().amax(dim=(1, 2))
        rel = diff / scale
        eye_err = float((got[0] - torch.eye(r, device=device)).abs().max())
        check(eye_err <= 1e-6, f"r={r}: zero system with unit ridge is "
              f"{eye_err} off the identity")
        rel_ok = float(rel[2:].max())
        rel_rd = float(rel[1])
        check(rel_ok <= REL_TOL, f"r={r}: rel err {rel_ok} > {REL_TOL}")
        check(rel_rd <= REL_TOL_RANK_DEF,
              f"r={r}: rank-deficient rel err {rel_rd} > {REL_TOL_RANK_DEF}")
        ms = cuda_ms(lambda: block_chol.chol_inverse_small(a, ridge))
        plain_ms = cuda_ms(lambda: block_chol.chol_inverse_small_ref(a, ridge))
        by_r[r] = dict(max_abs_err=float(diff.max()), max_rel_err=rel_ok,
                       rank_def_rel_err=rel_rd, ms=ms, plain_ms=plain_ms)
        say("kernel", f"r={r} N={n}: max abs err {float(diff.max()):.3e}, "
            f"max rel err {rel_ok:.3e} (tol {REL_TOL:g}), rank-deficient "
            f"rel err {rel_rd:.3e} (tol {REL_TOL_RANK_DEF:g}); kernel "
            f"{ms:.4f} ms, plain torch {plain_ms:.4f} ms")
    return by_r


def time_at(block_chol, device, shape):
    """Kernel and plain times at one [N, r, r] shape, in turns plain,
    kernel, kernel, plain; the better of each pair."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    a, ridge = spd_batch(gen, shape[0], shape[1], device)
    k = lambda: block_chol.chol_inverse_small(a, ridge)
    p = lambda: block_chol.chol_inverse_small_ref(a, ridge)
    p1, k1, k2, p2 = cuda_ms(p), cuda_ms(k), cuda_ms(k), cuda_ms(p)
    return {"ms": min(k1, k2), "plain_ms": min(p1, p2)}


def phase_solve(block_chol, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    worst = {}
    for d in (8, 32, 64, 128, 512):
        n = 128 if d == 512 else 1024
        a, ridge = spd_batch(gen, n, d, device)
        ridge = ridge[:, 0].contiguous()          # a [N] ridge
        b = torch.randn((n, d), generator=gen, device=device)
        a[3] = 0.0                                # padded row: zero system
        b[3] = 0.0
        v = torch.randn((3, d), generator=gen, device=device)
        a[5] = v.T @ v                            # rank 3, no ridge at all
        ridge[5] = 0.0
        x = block_chol.spd_solve(a, b, ridge)
        aa = (a + ridge[:, None, None] * torch.eye(d, device=device)).double()
        keep = torch.ones(n, dtype=torch.bool, device=device)
        keep[[3, 5]] = False
        want = torch.linalg.solve(aa[keep], b[keep].double()[..., None])[..., 0]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(x).all()), f"spd_solve d={d}: nonfinite")
        check(bool((x[3] == 0).all()), f"spd_solve d={d}: zero row not zero")
        err = (x[keep].double() - want).abs()
        bound = SOLVE_ATOL + SOLVE_RTOL * want.abs()
        check(bool((err <= bound).all()),
              f"spd_solve d={d}: max err {float(err.max())} over "
              f"atol {SOLVE_ATOL} + rtol {SOLVE_RTOL}")
        worst[d] = float((err / bound).max())
    say("solve", "spd_solve vs float64 torch.linalg.solve within atol "
        f"{SOLVE_ATOL:g} + rtol {SOLVE_RTOL:g}: worst err/bound by d "
        + ", ".join(f"{d}: {w:.3f}" for d, w in worst.items()))


def train(cli, dim: int, epochs: int):
    base = [os.path.join(ML1M, f) for f in
            ("train.csv", "validation_tr.csv", "validation_te.csv")]
    argv = README_ARGS + [
        "--train_data", base[0], "--test_train_data", base[1],
        "--test_test_data", base[2], "--dim", str(dim),
        "--epoch", str(epochs), "--device", "cuda"]
    return cli.run(argv)


def check_dual(res, tag: str) -> None:
    bad = [w for w in res.mean_weights if abs(w - ALPHA) > DUAL_TOL]
    check(not bad, f"{tag}: mean dual weight left {ALPHA} +/- {DUAL_TOL}: "
          f"{res.mean_weights}")


def phase_serve(model):
    import numpy as np
    import torch

    from safer2_recommender_tpu_torch.data.dataset import Dataset

    hist = Dataset.from_csv(os.path.join(ML1M, "validation_tr.csv"))
    users = np.unique(hist.user_ids)
    served, secs = 0, 0.0
    for i in range(3):
        sel = users[i * 256:(i + 1) * 256]
        m = np.isin(hist.user_ids, sel)
        batch = Dataset(hist.user_ids[m], hist.item_ids[m])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_users, ids = model.recommend(batch, k=10)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
        check(list(got_users) == list(sel), f"batch {i}: users misaligned")
        check(ids.shape == (sel.size, 10), f"batch {i}: shape {ids.shape}")
        check(bool(((ids >= 0) & (ids < model.num_items)).all()),
              f"batch {i}: item id out of range")
        seen = set(zip(batch.user_ids.tolist(), batch.item_ids.tolist()))
        for u, row in zip(got_users.tolist(), ids.tolist()):
            check(not any((u, it) in seen for it in row),
                  f"batch {i}: user {u} was recommended a history item")
        served += sel.size
    say("serve", f"3 batches x 256 users, k=10: {served} users in "
        f"{secs * 1000:.1f} ms = {served / secs:.1f} users/s "
        "(fold-in + full-catalog scoring + exact top-k)")
    return served / secs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "safer2_recommender_tpu_torch")):
        print("chip_smoke: safer2_recommender_tpu_torch/ not found beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from safer2_recommender_tpu_torch import cli
    from safer2_recommender_tpu_torch.ops import block_chol

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    block_chol.build_kernel()
    say("build", f"chol_inverse.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    by_r = phase_kernel(block_chol, device)
    phase_solve(block_chol, device)

    # record the shapes the main path hands the kernel (the shim counts
    # nothing; the wrapper's own LAUNCHES does)
    shapes, wrapper = [], block_chol.chol_inverse_small

    def recording(a, ridge):
        shapes.append(tuple(a.shape))
        return wrapper(a, ridge)

    block_chol.chol_inverse_small = recording
    block_chol.reset_launches()
    try:
        res = train(cli, 32, 10)
    finally:
        block_chol.chol_inverse_small = wrapper
    main_launches = block_chol.total_launches()
    check(len(shapes) == main_launches, "dim 32: launches do not match calls")
    state = res.model.state
    check(state.user_emb.is_cuda and state.item_emb.is_cuda,
          "dim 32: model tables are not on the GPU")
    check(main_launches > 0, "dim 32: the kernel was never launched")
    ndcg20 = float(res.metrics.mean_ndcg()[2])
    check(ndcg20 >= NDCG20_MIN, f"dim 32: NDCG@20 {ndcg20} < {NDCG20_MIN}")
    check_dual(res, "dim 32")
    say("train", f"ML-1M SAFER2 dim 32, 10 epochs: NDCG@20 {ndcg20:.4f} "
        f"(gate {NDCG20_MIN}); mean dual weight per epoch "
        f"{[round(w, 4) for w in res.mean_weights]} (gate {ALPHA} +/- "
        f"{DUAL_TOL}); epoch ms {res.epoch_ms}; kernel launches "
        f"{main_launches} by r {dict(block_chol.LAUNCHES)}")

    block_chol.reset_launches()
    users_per_s = phase_serve(res.model)
    main_launches += block_chol.total_launches()

    block_chol.reset_launches()
    res64 = train(cli, 64, 3)
    s64 = res64.model.state
    check(bool(torch.isfinite(s64.user_emb).all()
               and torch.isfinite(s64.item_emb).all()),
          "dim 64: nonfinite tables")
    check(block_chol.LAUNCHES[64] > 0, "dim 64: no r = 64 kernel launch")
    check_dual(res64, "dim 64")
    say("dim64", f"ML-1M SAFER2 dim 64, 3 epochs: NDCG@20 "
        f"{float(res64.metrics.mean_ndcg()[2]):.4f}; mean dual weight "
        f"{[round(w, 4) for w in res64.mean_weights]}; epoch ms "
        f"{res64.epoch_ms}; kernel launches by r {dict(block_chol.LAUNCHES)}")

    main_shape = max(shapes)            # the U sweep's [N, 32, 32]
    main_t = time_at(block_chol, device, main_shape)
    say("kernel", f"main-path shape {list(main_shape)}: kernel "
        f"{main_t['ms']:.4f} ms, plain torch {main_t['plain_ms']:.4f} ms")
    print(json.dumps({"kernels": [{
        "name": "chol_inverse",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/chol_inverse.cu",
        "replaces": ("safer2_recommender_tpu/ops/block_chol.py:120 "
                     "(_leaf_lane/_leaf_kernel); "
                     "safer2_recommender_tpu/ops/block_chol.py:163 "
                     "(_lane_matmul/_lane_matmul_kernel)"),
        "launches": main_launches,
        "max_abs_err": max(v["max_abs_err"] for v in by_r.values()),
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "shape": list(main_shape),
        "by_r": {str(r): v for r, v in by_r.items()},
        "serve_users_per_s": users_per_s,
        "ml1m_dim32_epoch_ms": res.epoch_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
