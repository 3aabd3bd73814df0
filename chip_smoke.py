#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (safer2_recommender_tpu_torch)
on one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing lines to stdout tagged with its name:
  1. device: requires CUDA, turns TF32 off, prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles both kernels from csrc/ (sm_90a), one nvcc each,
     started together, and prints what nvcc -Xptxas -v says of the
     inverse-Cholesky kernel (registers, shared memory, spills);
  3. kernel: compares the inverse-Cholesky kernel with its plain torch
     version on the card at r = 8/16/32/64 (probes/chol_inverse.py), at
     N = 4096 and the ragged N (0, 1, one block's systems +/- 1, 4097),
     each batch with an all-zero system under a unit ridge (the identity
     within 1e-6) and a rank-deficient one, and exact zeros above the
     diagonal; then times it at N = 4096 in turns beside its bound, the
     plain version and the library pair cholesky_ex + solve_triangular;
  4. bdot: compares the batched-dot kernel with its plain torch version
     (chained torch.bmm) at h = 32/64/128, N = 4096, 8 dots, within 1e-4
     of max|plain| (the f32 summation order differs); the probe of
     phase 11 times both;
  5. solve: spd_solve against a float64 torch.linalg.solve at
     d = 8/32/64/128/512;
  6. train: the port's CLI in-process, SAFER2 on the bundled ML-1M split
     at the README's dim-32 config for 10 epochs; NDCG@20 >= 0.2 and
     mean dual weight within alpha +/- 0.02 after every epoch;
  7. serve: 3 recommend() batches of 256 held-out users from the dim-32
     model; ids in range and outside each user's history;
  8. dim64: the same run at dim 64 for 3 epochs (the r = 64 kernel
     path); finite tables and the dual-weight gate;
  9. dim512: the same run at dim 512 for 10 epochs (Woodbury solves,
     rotated direct solves, the warm eigh refresh): the quality gates,
     finite tables, rows on the Woodbury and rotated paths, a warm
     refresh, kernel launches at every r, then one recommend() batch of
     256 users with the serve checks;
 10. synth50k: the library API on the 50k-user power-law workload at the
     MSD config (dim 512) for 3 epochs: finite tables, rows through the
     column-chunked wide assembly, each epoch's ms and the peak device
     memory;
 11. probe: the batched-dot probe (probes/bdot.py), the bdot kernel's
     own path, beside plain torch.bmm and the dim-512 solver's products;
     then the launches of the inverse-Cholesky kernel on the dim512 and
     synth50k paths by r and N against one wave of the card, and the
     kernel against its plain version at the largest and the most
     frequent shape of each path, compared and timed as in phase 3.
Every path's kernel launch counts are set to 0 just before it and read
just after. Then a JSON line describing the kernels (launch counts on
their paths, errors, times) and, last, {"ok": true, "device": {...}}.
Any failed check raises, so the script exits nonzero and never prints
the last line. Without CUDA, or without the package beside it, it
exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
ML1M = os.path.join(ROOT, "tests", "ml-1m")
REL_TOL = 1e-4          # kernel vs plain, well-conditioned systems
REL_TOL_RANK_DEF = 1e-3  # the rank-deficient system (ridge 1e-2)
EYE_TOL = 1e-6          # the all-zero system with a unit ridge vs identity
SOLVE_RTOL, SOLVE_ATOL = 2e-3, 2e-4   # the JAX package's spd_solve bounds
BDOT_REL_TOL = 1e-4     # bdot kernel vs chained torch.bmm, of max|plain|
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


def phase_kernel(chol_probe, device):
    """The inverse-Cholesky kernel against its plain version at every r
    (``probes/chol_inverse.py::run``): N = 4096 and the ragged N, each
    batch with an all-zero system under a unit ridge (must give the
    identity within 1e-6) and a rank-deficient one; exact zeros above
    the diagonal. The probe then times it at N = 4096 in turns beside
    its bound, the plain version and the library pair."""
    by_r = chol_probe.run(device)
    for r, e in by_r.items():
        check(e["finite"], f"r={r}: nonfinite output")
        check(e["upper_zero"], f"r={r}: nonzero entry above the diagonal")
        check(e["eye_err"] <= EYE_TOL, f"r={r}: zero system with unit ridge "
              f"is {e['eye_err']} off the identity")
        check(e["max_rel_err"] <= REL_TOL,
              f"r={r}: rel err {e['max_rel_err']} > {REL_TOL}")
        check(e["rank_def_rel_err"] <= REL_TOL_RANK_DEF,
              f"r={r}: rank-deficient rel err {e['rank_def_rel_err']} > "
              f"{REL_TOL_RANK_DEF}")
        say("kernel", f"r={r}, N in {e['n_checked']}: max abs err "
            f"{e['max_abs_err']:.3e}, max rel err {e['max_rel_err']:.3e} "
            f"(tol {REL_TOL:g}), rank-deficient rel err "
            f"{e['rank_def_rel_err']:.3e} (tol {REL_TOL_RANK_DEF:g}), "
            f"identity err {e['eye_err']:.1e} (tol {EYE_TOL:g}), zero above "
            f"the diagonal")
    return by_r


def time_at(chol_probe, device, shape):
    """The kernel against its plain version at one [N, r, r] shape of
    the main path (relative error of each system within REL_TOL, exact
    zeros above the diagonal), then timed in turns beside its bound, the
    plain version and the library pair."""
    import torch

    from safer2_recommender_tpu_torch.ops import block_chol

    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    a, ridge = chol_probe.spd_batch(gen, shape[0], shape[1], device)
    got = block_chol.chol_inverse_small(a, ridge)
    want = block_chol.chol_inverse_small_ref(a, ridge)
    torch.cuda.synchronize()
    e = chol_probe.errors(got, want, hard=False)
    check(e["finite"], f"{list(shape)}: nonfinite output")
    check(e["upper_zero"], f"{list(shape)}: nonzero above the diagonal")
    check(e["max_rel_err"] <= REL_TOL,
          f"{list(shape)}: rel err {e['max_rel_err']} > {REL_TOL}")
    row = chol_probe.measure(a, ridge)
    row.update(max_abs_err=e["max_abs_err"], max_rel_err=e["max_rel_err"])
    return row


def launch_histogram(shapes, wave):
    """{r: {"launches", "below_one_wave", "n_bins": {"[lo, hi)": count}}}
    of recorded [N, r, r] shapes; wave[r] is the systems the card holds
    at once at that r."""
    hist = {}
    for n, r, _ in shapes:
        h = hist.setdefault(r, {"launches": 0, "below_one_wave": 0,
                                "one_wave": wave[r], "n_bins": {}})
        h["launches"] += 1
        h["below_one_wave"] += n < wave[r]
        lo = 1 << max(n, 1).bit_length() - 1
        key = f"[{lo}, {2 * lo})"
        h["n_bins"][key] = h["n_bins"].get(key, 0) + 1
    return {r: hist[r] for r in sorted(hist)}


def most_frequent(shapes):
    return Counter(shapes).most_common(1)[0][0]


def phase_solve(block_chol, chol_probe, device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    worst = {}
    for d in (8, 32, 64, 128, 512):
        n = 128 if d == 512 else 1024
        a, ridge = chol_probe.spd_batch(gen, n, d, device)
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


def phase_bdot(bdot, device):
    """The batched-dot kernel against chained torch.bmm on the same
    inputs; these launches compare and do not count toward the path
    (the probe times both)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    n, n_dots, scale = 4096, 8, 1e-2
    by_h = {}
    for h in bdot.SIZES:
        x = torch.randn((n, h, h), generator=gen, device=device) * 0.1
        got = bdot.bdot(x, n_dots, scale)
        want = bdot.bdot_ref(x, n_dots, scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"bdot h={h}: nonfinite")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        check(rel <= BDOT_REL_TOL, f"bdot h={h}: rel err {rel} > "
              f"{BDOT_REL_TOL}")
        by_h[h] = dict(max_abs_err=err, rel_err=rel)
        say("bdot", f"h={h} N={n} dots={n_dots}: max abs err {err:.3e}, "
            f"rel err {rel:.3e} of max|plain| (tol {BDOT_REL_TOL:g})")
    return by_h


@contextlib.contextmanager
def recorded_chol_shapes(block_chol):
    """Record the [N, r, r] shapes the wrapped path hands the kernel
    wrapper (the shim counts nothing; the wrapper's LAUNCHES does)."""
    shapes, wrapper = [], block_chol.chol_inverse_small

    def recording(a, ridge):
        shapes.append(tuple(a.shape))
        return wrapper(a, ridge)

    block_chol.chol_inverse_small = recording
    try:
        yield shapes
    finally:
        block_chol.chol_inverse_small = wrapper


def finite_tables(state) -> bool:
    import torch

    return bool(torch.isfinite(state.user_emb).all()
                and torch.isfinite(state.item_emb).all())


def phase_serve(model, batches: int, phase: str = "serve"):
    import numpy as np
    import torch

    from safer2_recommender_tpu_torch.data.dataset import Dataset

    hist = Dataset.from_csv(os.path.join(ML1M, "validation_tr.csv"))
    users = np.unique(hist.user_ids)
    served, secs = 0, 0.0
    for i in range(batches):
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
    say(phase, f"{batches} batch(es) x 256 users, k=10: {served} users in "
        f"{secs * 1000:.1f} ms = {served / secs:.1f} users/s "
        "(fold-in + full-catalog scoring + exact top-k)")
    return served / secs


def phase_dim512(cli, block_chol, woodbury):
    """ML-1M at dim 512 through the CLI: the Woodbury and rotated paths,
    the warm refresh, and the r = 8..64 kernel launches they make."""
    import torch

    from safer2_recommender_tpu_torch.probes import cuda_ms

    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    with recorded_chol_shapes(block_chol) as shapes:
        res = train(cli, 512, 10)
    launches = dict(block_chol.LAUNCHES)
    paths = dict(woodbury.SOLVE_PATHS)
    peak = torch.cuda.max_memory_allocated()
    check(len(shapes) == sum(launches.values()),
          "dim 512: launches do not match calls")
    check(finite_tables(res.model.state), "dim 512: nonfinite tables")
    ndcg20 = float(res.metrics.mean_ndcg()[2])
    check(ndcg20 >= NDCG20_MIN, f"dim 512: NDCG@20 {ndcg20} < {NDCG20_MIN}")
    check_dual(res, "dim 512")
    check(paths["woodbury"] > 0 and paths["rotated"] > 0,
          f"dim 512: a solve path was not taken: {paths}")
    check(paths["refresh_warm"] > 0, f"dim 512: no warm refresh: {paths}")
    check(all(launches[r] > 0 for r in block_chol.KERNEL_SIZES),
          f"dim 512: no kernel launch at some r: {launches}")
    say("dim512", f"ML-1M SAFER2 dim 512, 10 epochs: NDCG@20 {ndcg20:.4f} "
        f"(gate {NDCG20_MIN}); mean dual weight "
        f"{[round(w, 4) for w in res.mean_weights]}; epoch ms "
        f"{res.epoch_ms}; solve paths (padded rows; refreshes) {paths}; "
        f"kernel launches by r {launches}; largest kernel shape "
        f"{list(max(shapes, key=lambda s: s[0] * s[1] * s[2]))}; peak "
        f"device memory {peak} B")
    # the two eigh branches on the trained model's own Gramian and basis
    # (tol 1 forces the warm one); outside the counted run
    state = res.model.state
    eigh_ms = {
        "cold": cuda_ms(lambda: torch.linalg.eigh(state.item_gramian)),
        "warm": cuda_ms(lambda: woodbury.refresh_eigh(
            state.item_gramian, state.eig_qu, 1.0))}
    say("dim512", f"eigh of the [512, 512] Gramian: cold (torch.linalg.eigh)"
        f" {eigh_ms['cold']:.3f} ms, warm refresh (4 x [128, 128] blocks) "
        f"{eigh_ms['warm']:.3f} ms")
    block_chol.reset_launches()
    serve = phase_serve(res.model, 1, "dim512")
    return dict(res=res, launches=launches, shapes=shapes, paths=paths,
                serve=serve, serve_launches=block_chol.total_launches(),
                eigh_ms=eigh_ms, peak_bytes=peak)


def phase_synth(block_chol, woodbury, device, epochs=3):
    """The library API on the MSD-shaped synthetic workload (50k x 40k,
    dim 512) at the MSD config (bench.py's north star): finite tables and
    rows through the wide (column-chunked) assembly; epoch ms and peak
    device memory."""
    import torch

    from safer2_recommender_tpu_torch import get_model
    from safer2_recommender_tpu_torch.probes import epoch_profile

    t0 = time.perf_counter()
    ds, dd, cfg = epoch_profile.workload("synth50k", device)
    setup_s = time.perf_counter() - t0
    model = get_model("safer2", cfg, ds.num_users, ds.num_items,
                      device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    epoch_ms, weights = [], []
    with recorded_chol_shapes(block_chol) as shapes:
        model.initialize(dd)
        for _ in range(epochs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.train_epoch(dd)
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t1) * 1000)
            weights.append(model.get_mean_weight())
    launches = dict(block_chol.LAUNCHES)
    paths = dict(woodbury.SOLVE_PATHS)
    peak = torch.cuda.max_memory_allocated()
    check(finite_tables(model.state), "synth50k: nonfinite tables")
    check(paths["wide"] > 0, f"synth50k: no wide rows: {paths}")
    check(paths["woodbury"] > 0, f"synth50k: no Woodbury rows: {paths}")
    check(sum(launches.values()) > 0, "synth50k: no kernel launch")
    check(len(shapes) == sum(launches.values()),
          "synth50k: launches do not match calls")
    say("synth50k", f"{ds.num_users} users x {ds.num_items} items, "
        f"{ds.nnz} tuples, dim {cfg.dim}, {epochs} epochs: first epoch "
        f"{epoch_ms[0]} ms, then {epoch_ms[1:]} ms (synchronized host "
        f"clock); data + bucketing {setup_s:.1f} s; mean dual weight "
        f"{weights}; solve paths (padded rows; refreshes) {paths}; kernel "
        f"launches by r {launches}; peak device memory {peak} B")
    return dict(epoch_ms=epoch_ms, paths=paths, launches=launches,
                peak_bytes=peak, shapes=shapes)


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
    from safer2_recommender_tpu_torch.ops import bdot, block_chol, woodbury
    from safer2_recommender_tpu_torch.probes import bdot as bdot_probe
    from safer2_recommender_tpu_torch.probes import chol_inverse as chol_probe

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
    with ThreadPoolExecutor(3) as ex:
        builds = [ex.submit(block_chol.build_kernel), ex.submit(bdot.build_kernel)]
        ptxas = ex.submit(chol_probe.ptxas_report)
        for f in builds:
            f.result()
        ptxas = ptxas.result()
    say("build", f"chol_inverse.cu and bdot.cu built (in parallel) and "
        f"loaded in {time.perf_counter() - t0:.1f} s")
    say("build", "nvcc -Xptxas -v of chol_inverse.cu: " + " | ".join(ptxas))

    by_r = phase_kernel(chol_probe, device)
    by_h = phase_bdot(bdot, device)
    phase_solve(block_chol, chol_probe, device)

    block_chol.reset_launches()
    with recorded_chol_shapes(block_chol) as shapes:
        res = train(cli, 32, 10)
    dim32_launches = block_chol.total_launches()
    check(len(shapes) == dim32_launches, "dim 32: launches do not match calls")
    state = res.model.state
    check(state.user_emb.is_cuda and state.item_emb.is_cuda,
          "dim 32: model tables are not on the GPU")
    check(dim32_launches > 0, "dim 32: the kernel was never launched")
    ndcg20 = float(res.metrics.mean_ndcg()[2])
    check(ndcg20 >= NDCG20_MIN, f"dim 32: NDCG@20 {ndcg20} < {NDCG20_MIN}")
    check_dual(res, "dim 32")
    say("train", f"ML-1M SAFER2 dim 32, 10 epochs: NDCG@20 {ndcg20:.4f} "
        f"(gate {NDCG20_MIN}); mean dual weight per epoch "
        f"{[round(w, 4) for w in res.mean_weights]} (gate {ALPHA} +/- "
        f"{DUAL_TOL}); epoch ms {res.epoch_ms}; kernel launches "
        f"{dim32_launches} by r {dict(block_chol.LAUNCHES)}")

    block_chol.reset_launches()
    users_per_s = phase_serve(res.model, 3)
    serve_launches = block_chol.total_launches()
    check(serve_launches > 0, "serve: the kernel was never launched")

    block_chol.reset_launches()
    res64 = train(cli, 64, 3)
    check(finite_tables(res64.model.state), "dim 64: nonfinite tables")
    check(block_chol.LAUNCHES[64] > 0, "dim 64: no r = 64 kernel launch")
    check_dual(res64, "dim 64")
    say("dim64", f"ML-1M SAFER2 dim 64, 3 epochs: NDCG@20 "
        f"{float(res64.metrics.mean_ndcg()[2]):.4f}; mean dual weight "
        f"{[round(w, 4) for w in res64.mean_weights]}; epoch ms "
        f"{res64.epoch_ms}; kernel launches by r {dict(block_chol.LAUNCHES)}")
    dim64_launches = block_chol.total_launches()
    del res64

    d512 = phase_dim512(cli, block_chol, woodbury)
    check(d512["serve_launches"] > 0,
          "dim512 serve: the kernel was never launched")
    ndcg512 = float(d512.pop("res").metrics.mean_ndcg()[2])
    shapes512 = d512.pop("shapes")

    synth = phase_synth(block_chol, woodbury, device)

    bdot.reset_launches()
    probe = bdot_probe.run(device=device)
    probe_launches = bdot.LAUNCHES
    check(probe_launches > 0, "probe: the bdot kernel was never launched")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = {r: sms * block_chol.resident_systems(r)
            for r in block_chol.KERNEL_SIZES}
    shapes50k = synth.pop("shapes")
    hist = {"ml1m_dim512": launch_histogram(shapes512, wave),
            "synth50k_dim512": launch_histogram(shapes50k, wave)}
    say("kernel", f"one wave (SMs x systems resident on one) by r: {wave}; "
        f"launches by r and N, ML-1M dim 512 (10 epochs + eval + serve "
        f"batch excluded) and synth50k (3 epochs): {json.dumps(hist)}")
    size = lambda sh: sh[0] * sh[1] * sh[2]
    main_shapes = {
        "largest_ml1m_dim512": max(shapes512, key=size),
        "most_frequent_ml1m_dim512": most_frequent(shapes512),
        "largest_synth50k": max(shapes50k, key=size),
        "most_frequent_synth50k": most_frequent(shapes50k)}
    main_t = {}
    for key, shape in main_shapes.items():
        main_t[key] = time_at(chol_probe, device, shape)
        say("kernel", f"{key} {chol_probe.describe(main_t[key])}; max rel "
            f"err {main_t[key]['max_rel_err']:.3e} (tol {REL_TOL:g})")
    head = main_t["largest_ml1m_dim512"]
    probe_h = {row["h"]: row for row in probe["bdot"]}
    print(json.dumps({"kernels": [{
        "name": "chol_inverse",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/chol_inverse.cu",
        "replaces": ("safer2_recommender_tpu/ops/block_chol.py:120 "
                     "(_leaf_lane/_leaf_kernel); "
                     "safer2_recommender_tpu/ops/block_chol.py:163 "
                     "(_lane_matmul/_lane_matmul_kernel)"),
        "launches": sum(d512["launches"].values()),
        "max_abs_err": max([v["max_abs_err"] for v in by_r.values()]
                           + [v["max_abs_err"] for v in main_t.values()]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "device_ms": head["device_ms"],
        "cholesky_ex_ms": head["cholesky_ex_ms"],
        "shape": head["shape"],
        "main_path_shapes": main_t,
        "launch_histogram": hist,
        "one_wave": wave,
        "ptxas": ptxas,
        "launches_by_path": {
            "ml1m_dim32": dim32_launches, "serve_dim32": serve_launches,
            "ml1m_dim64": dim64_launches,
            "ml1m_dim512": d512["launches"],
            "serve_dim512": d512["serve_launches"],
            "synth50k_dim512": synth["launches"]},
        "by_r": {str(r): v for r, v in by_r.items()},
        "serve_users_per_s": users_per_s,
        "ml1m_dim32_epoch_ms": res.epoch_ms,
        "ml1m_dim512_ndcg20": ndcg512,
        "ml1m_dim512": d512,
        "synth50k": synth,
    }, {
        "name": "bdot",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/bdot.cu",
        "replaces": "scripts/probe_bdot.py:27 (pallas_bdot)",
        "launches": probe_launches,
        "max_abs_err": max(v["max_abs_err"] for v in by_h.values()),
        "ms": probe_h[128]["ms"],
        "plain_ms": probe_h[128]["plain_ms"],
        "bound_ms": probe_h[128]["bound_ms"],
        "bound_by": probe_h[128]["bound_by"],
        "library_ms": probe_h[128]["library_ms"],
        "shape": [4096, 128, 128],
        "by_h": {str(h): dict(v, **probe_h[h]) for h, v in by_h.items()},
        "probe": probe,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
