#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (safer2_recommender_tpu_torch)
on one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing lines to stdout tagged with its name:
  1. device: requires CUDA, turns TF32 off, prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the three kernel sources from csrc/ (sm_90a), one
     nvcc each, started together, and prints what nvcc -Xptxas -v says
     of each kernel of chol_inverse.cu, bdot.cu and grad_gather.cu
     (registers, shared memory, spills);
  3. kernel: compares the inverse-Cholesky kernel with its plain torch
     version on the card at r = 8/16/32/64 (probes/chol_inverse.py), at
     N = 4096 and the ragged N (0, 1, one block's systems +/- 1, 4097),
     each batch with an all-zero system under a unit ridge (the identity
     within 1e-6) and a rank-deficient one, and exact zeros above the
     diagonal; then times it at N = 4096 in turns beside its bound, the
     plain version and the library pair cholesky_ex + solve_triangular;
  4. bdot: compares the batched-dot kernel (x^(n_dots + 1) scaled, by
     repeated squaring on the tensor cores) with its plain torch version
     at h = 32/64/128, both precisions ("highest", 3xTF32; "default",
     one TF32 pass), N = 0, 1, 2, one block's matrices +/- 1, 4096 and
     4097, and n_dots = 0/1/3/8/13: within 1e-4 of max|plain| at
     "highest" (the f32 summation order differs) and 1e-3 at "default"
     (a last-bit difference flips a rounding to TF32), and at "highest"
     within 1e-5 of max|float64 chain| (the function's oracle, on the
     card); the probe of phase 18 times both;
  5. solve: spd_solve against a float64 torch.linalg.solve at
     d = 8/32/64/128/512;
 33. grad_gather (run after phase 5): CVaR-MF's gather-matvec kernel
     (probes/grad_gather.py) at the MSD-shape workload's buckets, dim
     512: per side a bucket of each of the three most frequent shapes
     and the one with the most real slots (on the item side the split
     [8 x 262144] head), stepped by the kernel and by the plain route
     (params_weighted_*, grad_from_params, scatter_bucket) from the same
     table, within the probe's CHECK_TOL (1e-5) of the plain step's
     largest entry; each one's kernel ms beside its bounds;
  6. train: the port's CLI in-process, SAFER2 on the bundled ML-1M split
     at the README's dim-32 config for 10 epochs; NDCG@20 >= 0.2 and
     mean dual weight within alpha +/- 0.02 after every epoch;
  7. serve: 3 recommend() batches of 256 held-out users from the dim-32
     model; ids in range and outside each user's history;
  8. dim64: the same run at dim 64 for 3 epochs (the r = 64 kernel
     path); finite tables and the dual-weight gate;
  9. dim512: the same run at dim 512 for 10 epochs (Woodbury solves,
     rotated direct solves, a full eigh every sweep at the default
     eig_refresh_tol, 0): the quality gates, finite tables, rows on the
     Woodbury and rotated paths, no warm refresh, kernel launches at
     every r; then a DIM512_JAX_TOL_EPOCHS run at the JAX package's
     --eig_refresh_tol 0.08: a warm refresh at least, the NDCG@20 and
     dual-weight gates; the cold eigh and the warm refresh timed on the
     trained Gramian; then one recommend() batch of 256 users with the
     serve checks;
 10. synth50k: the library API on the 50k-user power-law workload at the
     MSD config (dim 512) for 2 epochs: finite tables, rows through the
     column-chunked wide assembly, each epoch's ms and the peak device
     memory;
 11. models: the CLI in-process for each of the other five models on
     ML-1M at dim 32 (block 8 for the ++ models) at the reference tests'
     configs, 10 epochs (CVaR-MF: 50): NDCG@20 >= 0.2, finite tables,
     SAFER2++'s mean dual weight within alpha +/- 0.02 after every
     epoch, kernel launches by r; CVaR-MF's every epoch launches the
     gather-matvec kernel once a bucket, the other models never;
 12. interleaved: the reference-order ++ sweep (--block_interleaved 1)
     through the CLI: SAFER2++ on ML-1M at dim 512, block 64, the
     README's MSD config, 50 epochs (NDCG@20 >= 0.2, mean dual weight
     within alpha +/- 0.02 after the last epoch, every epoch's printed:
     at this config the xi Newton step stalls off the quantile in the
     JAX package as in the port, see check_dual; finite tables), then the
     same run in frozen order for its NDCG@20; iALS++ at dim 32, block 8,
     the reference tests' config, 10 epochs (NDCG@20 >= 0.2); in every
     epoch of both, (dim / bs) x (user + item buckets) kernel launches at
     r = bs and no other;
 13. cg: SAFER2 --use_cg 1 through the CLI on ML-1M at dim 32 (README
     config, 10 epochs: NDCG@20 and the dual gate) and dim 512 (MSD
     config, 3 epochs: finite tables and the dual gate after the last
     epoch), no chol_inverse
     launch in either run, epoch ms beside the runs without --use_cg;
 14. synth50k-models: SAFER2++, iALS++, iALS, ERM-MF and CVaR-MF through
     the library API on the 50k workload at the MSD config (dim 512,
     block 64): initialize, one warm-up epoch and two timed ones, then
     for the ++ models one recommend() batch of the 256 users with the
     longest histories (the fold-in's 8 blockwise sweeps); per model the
     epoch ms, the rows by solve path, the kernel launches by r and how
     many sit under one wave, the peak device memory; finite tables,
     wide rows, and r = 64 launches for both ++ models; gather-matvec
     launches as in phase 11;
 15. server: the PyTorch path after training: each of the six ML-1M
     dim-32 models of phases 6 and 11, the two interleaved models of
     phase 12 and the two CG models of phase 13, whose CLI runs saved a
     checkpoint (--checkpoint_dir, a temporary directory), is restored
     into a fresh
     model (CheckpointManager.restore_with_meta + load_checkpoint_meta, no
     DeviceData built) and served by a Server(k=10), one CUDA graph per
     rung pair, over 8 request batches of 1-1000 held-out users (sizes
     from a fixed seed): ids equal to the trained model's recommend() on
     each batch but for swaps of items whose scores lie within
     probes/serving_scale.py's TIE_TOL of
     the row's top score (counted), no history item, the graph's ids
     bit-identical to the
     same program run eagerly, no new graph after the first pass,
     recommend_stream equal to the loop, chol_inverse launches of the
     first pass equal to the warm-ups plus the replays times the launches
     each capture recorded (none for a CG model, whose captured fold-in
     runs every CG iteration with no host read); users/s of the second
     pass, p50 ms at batch 64
     from the graph and from recommend(), chol_inverse launches per
     capture, the overlap of approx=True with the exact top-10;
 16. server50k: the same checks and readings at full width, the
     synth50k SAFER2 model and the synth50k-models SAFER2++ model (dim
     512) serving the 256 longest histories (past the 512-wide rung) and
     1,024 random users, plus the replays and the graph pool's size, and
     SAFER2++'s recommend() time on the 256 users;
 17. interleaved50k: SAFER2++ --block_interleaved through the library
     API on the 50k workload at the MSD config (dim 512, block 64):
     initialize, one warm-up epoch and two timed ones; epoch ms, peak
     device memory, rows through the column-chunked route (> 0), the
     launch count of every epoch as in phase 12, launches by r and N
     against one wave;
 18. probe (run after phase 29): the batched-dot probe
     (probes/bdot.py), the bdot kernel's own path: at [4096, h, h] and
     8 dots, each precision per call and
     from a CUDA graph beside its bound, its plain version and
     torch.linalg.matrix_power (f32, or TF32 for "default"); then plain
     torch.matmul at the dim-512 solver's products;
     then the launches of the inverse-Cholesky kernel on the dim512,
     synth50k and synth50k-models paths by r and N against one wave of
     the card, and the kernel against its plain version at the largest
     and the most frequent shape of each path (the interleaved paths of
     phases 12 and 17, the served paths of phases 15 and 16 and each
     rank's shapes of phase 20's (b) and (c) included), compared and
     timed as in phase 3, and compared at every other shape the served
     and meshed paths gave it; the largest and the most frequent shape
     of phases 21, 22 and 26 and of the served path of 23 are timed
     too;
 19. bf16 (run between phases 14 and 16): compute_dtype="bf16" beside
     float32. ML-1M SAFER2 at dim 512, the README config, 10 epochs
     through the CLI with --compute_dtype bf16 (saving a checkpoint),
     beside phase 9's float32 run: NDCG@20 >= 0.2 and within
     BF16_NDCG_TOL of the f32 run, the dual-weight gate every epoch,
     chol_inverse launches > 0 and equal to the f32 run's, shape for
     shape; both runs' epoch ms (median after the first), peak memory,
     rows by path. The 50k workload at the MSD config: SAFER2 and
     SAFER2++ (frozen, block 64) in bf16 for 2 epochs each (epoch ms,
     mean dual weight, peak memory, launches), then 2 epochs of each of
     the four models (f32 models of phases 10 and 14 and the two bf16
     ones) under torch.profiler: wall ms, device busy share (the union
     of device intervals, probes/epoch_profile.py) and the top device
     operations. One 50k item bucket's Gramian and rhs on the card from
     the bf16 slab: the route ops/assemble.py::gram_route picks (printed)
     against the plain float32 product of the same bfloat16 operands,
     within GRAM_REL_TOL of max|plain|. A Server restored from the bf16
     ML-1M checkpoint, checked and timed as in phase 15 on its batches,
     then 2 profiled epochs of the f32 and the bf16 ML-1M model.
     Last, a 2-epoch CLI run (dim 32, bf16) with --profile_dir: the
     trace file exists and its device kernels include chol_inverse.
 20. mesh (run after phase 17): the data-parallel runtime
     (parallel/mesh.py). (a) --distributed 1 through the CLI in this
     process, torchrun's environment set for one rank (NCCL, world size
     1): phase 9's ML-1M dim-512 run again, NDCG@20 >= 0.2 and within
     MESH_NDCG_TOL of phase 9's, the dual gate every epoch, the same
     chol_inverse launch shapes, shape for shape. (b) SAFER2 and SAFER2++
     (frozen, block 64) on the 50k workload: one epoch in this process
     from a fresh initialization, then for each world size of MESH_RANKS
     (2 and 8) that many spawned ranks on this one card over gloo with
     CUDA tensors (NCCL refuses two ranks on one GPU), each model one
     epoch from the same initial tables: tables within rtol 5e-3, atol
     5e-5 x dim/8 of the one-process epoch, mean dual weight within
     1e-4, the ranks' tables bitwise equal (a checksum all-gathered),
     chol_inverse launches per rank equal in count and r to the
     one-process epoch's at about 1/n of the systems and equal shape
     for shape across ranks, one all-gather per sweep and one for the
     losses, their bytes within the JAX package's budget of the U+V
     table bytes, each rank's epoch ms beside the one-process one, the
     buckets that leave some rank only padding counted. (c) a
     Server(k=10) on the meshed SAFER2 over the 256 longest histories
     and 1,024 random users: ids equal its recommend()'s but for
     near-tie swaps, equal across ranks; the kernel's shapes recorded.
     (d) --mesh (device count + 1) exits non-zero with the JAX CLI's
     "exceeds" message. No check here times more than one card: ranks
     that share it check function, never scaling.
 24. dryrun8 (after phase 20): dryrun.dryrun_multichip(8, "cuda"), the
     JAX package's dryrun_multichip(8): all six models and interleaved
     SAFER2++ on 8 ranks sharing this card, a finite loss and the SAFER
     models' mean dual weight within alpha +/- 0.02 on every rank, every
     rank in a world of 8, the ranks' readings equal.
 25. multichip: probes/multichip.py's collective audit at 8 ranks
     (SAFER2, SAFER2++, iALS at 8,000 x 2,000, dim 64: the same traffic
     on every rank, one all-gather per sweep and one for the losses,
     bytes within the JAX budgets; fold-in and scoring traffic beside
     their bases), then its ML-1M SAFER2 dim-32 epoch at 1, 2, 4 and 8
     ranks (finite tables, bitwise equal across ranks, the dual gate;
     each rank's epoch ms, labelled as ranks sharing one card).
 21. msd (after phase 25): the full synthetic MSD workload
     (probes/scale.py: 571,355 users x 41,140 items, ~20.3M tuples, seed
     0) at dim 512 and the MSD config through the library API: SAFER2
     (one warm-up and 2 timed epochs), iALS and iALS++ (block 64; one
     warm-up and one timed epoch each). Per model the set-up's host
     seconds, buckets and direct solve batches per side, initialize and
     epoch ms, users/s, rows by path, kernel launches by r and under one
     wave, peak memory beside the card's; finite tables, Woodbury and
     wide rows, r = 64 launches for iALS++, SAFER2's mean dual weight
     within alpha +/- 0.02 after the last epoch;
 22. eval-msd: the MSD protocol's 50,000 held-out users
     (probes/eval_scale.py::heldout_fold) evaluated by phase 21's SAFER2
     and iALS++ (8 blockwise fold-in sweeps, r = 64 launches):
     evaluate_dataset first and warm, fold-in and scoring ms apart, peak
     memory; finite metrics in [0, 1]; the first 2,048 held-out users
     as a fold of their own give the same per-user Recall@20 / NDCG@20
     as the whole fold, but for rows whose top 20 differ by near-tie
     swaps (TIE_TOL), counted;
 23. serve-msd: probes/serving_scale.py::serve with phase 21's SAFER2 on
     1,000 new users (bench_serving.py's draw): recommend(k=100) exact
     and approx, first call and best of 3, and a Server(k=100), its p50;
     ids in range and outside each user's history, the Server's ids
     equal to recommend()'s but for near-tie swaps.
 26. bench (after phase 23): safer2_recommender_tpu_torch/bench.py's
     main in this process, bench.py's record on the card (the six
     models' 50k dim-512 epochs, recommend() and Server serving of new
     users, ML-1M dim 32 epoch and NDCG@20): every key present and
     every number finite, NDCG@20 >= 0.2, the device named as
     nvidia-smi names it, no Server program built by the varying
     batches, chol_inverse launched;
 27. entry: dryrun.entry (the JAX package's __graft_entry__.entry, the
     serving forward step) on the card against its CPU result, every
     user's Recall and NDCG within ENTRY_TOL;
 28. classes: SAFER2 on the 50k workload, two epochs profiled and every
     device kernel sorted into op classes by the aten op that launched
     it (probes/epoch_profile.py): the classes sum to the kernels'
     device time within 0.1%, and the catch-all is split by the port's
     calling line;
 29. roofline: probes/roofline.py's attained rates beside the published
     peaks;
 30. ops (after phase 29): the four op-family probes at the JAX scripts'
     full sizes, each reading beside its bound: probes/quantile.py
     (CVaR-MF's exact xi at n = 571,000, alpha = 0.3: topk, sort,
     kthvalue and ops/quantile.py::exact_quantile bit-equal to each
     other and to numpy's np.partition), probes/gather.py (the zipf row
     gathers, the [2048, 160] bucket gathers and the port's
     gather_history, equal bit for bit to the float32 gather cast to
     their dtype and to a host gather at sampled slots; the 2,048-row
     write-backs and the port's scatter_bucket, each leaving numpy's
     table, with their host reads), probes/eigh.py (cuSOLVER eigh of the
     512 Gramian, the [2, 512] stack and the 11 sizes of
     probe_eigh2.py, finite, the port's own route
     (ops/woodbury.py::sym_eigh) and the float64 route reconstructing
     within RECON_TOL = 1e-5 and the port's orthogonal within ORTH_TOL =
     1e-4, cuSOLVER's float32 call (Jacobi) a reading; the port's route
     at every shape the epochs give it (ROUTE_SHAPES) held to the same,
     beside the candidate routes' ms and errors; Newton-Schulz; the
     drift readings; the port's refresh_eigh branch and ms beside a cold
     eigh) and probes/seqdot.py (dependent
     products at d = 256 and 512: each chain's first three products
     within 1e-4 of a float64 chain on the card, 1e-2 in TF32).
 31. oracle (after phase 30): probes/oracle.py's run on the card: each
     of the six models (the ++ models in both orders) built through
     get_model and DeviceData.build at dims 8, 128 and 512 (and the
     frozen ++ models at dim 64, block 32, the block-level Woodbury),
     its initial tables exported and its epochs (two for CVaR-MF, and
     for SAFER2, iALS and iALS++ at 256 and 512) held to the float64
     numpy oracle run from the same tables: rtol 2e-4, atol 2e-5 x
     max(1, dim / 8) on both tables, whichever refresh branch the epoch
     took; each epoch's branch the expected one (no warm refresh at the
     default eig_refresh_tol; SAFER2, iALS and iALS++ at 256 run at the
     default, held, and again at the JAX package's 0.08, whose second
     epochs must take the warm refresh and are readings, printed beside
     the held ones); at 512 every solve
     route of the model's epoch takes rows (the wide one through a
     lowered WIDE_SLAB_BYTES), every epoch within a max abs error of
     oracle.SHARP_ABS_512 (1.5e-5), and the same epochs run again with
     the raw float32 torch.linalg.eigh in place of woodbury.sym_eigh,
     the control: it must exceed that limit where the epoch decomposes
     the full-dim Gramian; the rows by route, the oracle's host
     seconds. Phases 9 and 10 also hold the
     eigenbases their models carry after the last epoch orthogonal
     within BASIS_ORTH_TOL.
 32. refresh (after phase 10): probes/refresh.py on ML-1M (SAFER2) and
     the 50k workload (SAFER2, iALS, iALS++), dim 512: from states of a
     default run, the next epoch at the JAX package's eig_refresh_tol
     0.08 and at the default 0; each eigh's branch, coupling share and
     ms (CUDA events), the U and V distance of the two epochs; ML-1M's
     10 epochs at each tolerance with NDCG@20, Recall@20, the mean dual
     weight and the warm refreshes of each epoch. Fails on tables that
     are not finite, a warm refresh at the default, a 0.08 branch its
     coupling share does not give, and the ML-1M quality gates of phase
     9 at either tolerance.
Every path's kernel launch counts are set to 0 just before it and read
just after; on a served path a capture counts no launch and each replay
counts the launches its capture recorded (serving.py), and each
program's capture launches are reported beside its replays. Then a JSON
line describing the kernels (launch counts on
their paths, errors, times) and, last, {"ok": true, "device": {...}}.
Any failed check raises, so the script exits nonzero and never prints
the last line. Without CUDA, or without the package beside it, it
exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
ML1M = os.path.join(ROOT, "tests", "ml-1m")
REL_TOL = 1e-4          # kernel vs plain, well-conditioned systems
REL_TOL_RANK_DEF = 1e-3  # the rank-deficient system (ridge 1e-2)
EYE_TOL = 1e-6          # the all-zero system with a unit ridge vs identity
SOLVE_RTOL, SOLVE_ATOL = 2e-3, 2e-4   # the JAX package's spd_solve bounds
BDOT_REL_TOL = {       # bdot kernel vs its plain version, of max|plain|
    "highest": 1e-4,    # the f32 summation order differs
    # TF32 operands: a last-bit difference in f32 flips a rounding to TF32
    # (one TF32 ulp, 2^-10); two plain versions of the same arithmetic
    # (f32 and float64 torch.bmm on the same rounded operands) differ by
    # up to 2.5e-4 (probes/bdot_design.py)
    "default": 1e-3}
BDOT_F64_TOL = 1e-5     # "highest" bdot kernel vs the float64 chain
BDOT_DOTS = (0, 1, 3, 8, 13)
NDCG20_MIN = 0.2
ALPHA = 0.3
DUAL_TOL = 0.02
README_ARGS = ["--model_name", "safer2", "--uobs_weight", "0.004",
               "--l2_reg", "0.004", "--alpha", str(ALPHA),
               "--bandwidth", "0.15"]
# the reference tests' ML-1M configs of the other five models
# (tests/test_models_ml1m.py), run at dim 32 with block 8: (args, epochs)
_IALS_ARGS = ["--uobs_weight", "0.1", "--l2_reg", "0.003",
              "--l2_reg_exp", "1.0"]
MODEL_RUNS = {
    "ials": (_IALS_ARGS, 10),
    "erm_mf": (["--uobs_weight", "0.004", "--l2_reg", "0.005",
                "--alpha", str(ALPHA)], 10),
    "ialspp": (_IALS_ARGS + ["--block_size", "8"], 10),
    "safer2pp": (README_ARGS[2:] + ["--block_size", "8"], 10),
    "cvar_mf": (["--uobs_weight", "0.008", "--l2_reg", "0.002",
                 "--alpha", str(ALPHA), "--stepsize", "0.4",
                 "--seed", "2"], 50),
}
SYNTH_MODELS = ("safer2pp", "ialspp", "ials", "erm_mf", "cvar_mf")
# the README's MSD config (bench.py:114-117), SAFER2 and SAFER2++ flags
MSD_ARGS = ["--uobs_weight", "0.0004", "--l2_reg", "0.0012",
            "--alpha", str(ALPHA), "--bandwidth", "0.1", "--use_snr", "1",
            "--sampling_ratio", "0.1"]
INTERLEAVED = ["--block_interleaved", "1"]
# phase 9's ML-1M dim-512 run, the float32 side of phase 19's A/B
DIM512_EPOCHS = 10
# phase 9's short run at the JAX package's eig_refresh_tol: on ML-1M
# at 0.08 the sweeps of epochs 1 and 2 refresh cold (coupling shares
# 0.84 and 0.0804 against 0.08 on an H100), those of epochs 3 and 4 take
# the warm branch once each (PERF.md)
DIM512_JAX_TOL_EPOCHS = 4
BF16 = ["--compute_dtype", "bf16"]
# bf16 vs f32 NDCG@20 on ML-1M dim 512: the JAX package's own ablation
# moved it by 1e-4 at dim 256 (BASELINE.md:183-185)
BF16_NDCG_TOL = 0.005
# a bf16 Gramian / rhs by the card's route vs the plain f32 product of
# the same bf16 operands, of max|plain|: the products are exact in f32,
# only the summation order (and the tensor cores' f32 adder) differs
GRAM_REL_TOL = 1e-5
# ML-1M SAFER2++ at dim 512 in the reference's order: the epochs of the
# record it is held to (BASELINE.md "Interleaved mode records")
INTERLEAVED_EPOCHS = 50
CG_EPOCHS_DIM512 = 3
# the orthogonality ||Q^T Q - I||_F the JAX package holds its carried
# (warm-refreshed) eigenbasis to (tests/test_torch_woodbury.py)
BASIS_ORTH_TOL = 1e-3
SERVE_SEED = 6
SERVE_BATCHES = 8
P50_REPEATS = 11


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


def check_at(chol_probe, device, shape):
    """The kernel against its plain version at one [N, r, r] shape of
    the main path: relative error of each system within REL_TOL, exact
    zeros above the diagonal. Returns (a, ridge, errors)."""
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
    return a, ridge, e


def time_at(chol_probe, device, shape):
    """``check_at``, then the kernel timed in turns beside its bound, the
    plain version and the library pair."""
    a, ridge, e = check_at(chol_probe, device, shape)
    row = chol_probe.measure(a, ridge)
    row.update(max_abs_err=e["max_abs_err"], max_rel_err=e["max_rel_err"])
    return row


def median(xs):
    return sorted(xs)[len(xs) // 2]


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


def train(cli, dim: int, epochs: int, args=README_ARGS, ckpt=None):
    base = [os.path.join(ML1M, f) for f in
            ("train.csv", "validation_tr.csv", "validation_te.csv")]
    argv = list(args) + [
        "--train_data", base[0], "--test_train_data", base[1],
        "--test_test_data", base[2], "--dim", str(dim),
        "--epoch", str(epochs), "--device", "cuda"]
    if ckpt is not None:
        argv += ["--checkpoint_dir", ckpt]
    return cli.run(argv)


def check_dual(res, tag: str, last_only: bool = False) -> None:
    """Mean dual weight within ALPHA +/- DUAL_TOL after every epoch, or,
    with ``last_only``, after the last: the MSD config's runs, whose xi
    Newton step stalls off the quantile in the JAX package as in the
    port (tests/test_torch_interleaved.py::
    test_msd_config_xi_stalls_where_the_jax_package_stalls), so an
    early epoch may leave the band in both."""
    weights = res.mean_weights[-1:] if last_only else res.mean_weights
    bad = [w for w in weights if abs(w - ALPHA) > DUAL_TOL]
    check(not bad, f"{tag}: mean dual weight left {ALPHA} +/- {DUAL_TOL}: "
          f"{res.mean_weights}")


def bdot_sizes(bdot, h: int):
    """N = 0, 1, 2, one block's matrices +/- 1, 4096 and 4097."""
    per_block = bdot.matrices_per_block(h)
    return sorted({0, 1, 2, max(per_block - 1, 0), per_block + 1, 4096,
                   4097})


def chain64(x, n_dots: int, scale: float):
    """The function's oracle: the probe's chain in float64."""
    import torch

    xd = x.double()
    acc = xd
    for _ in range(n_dots):
        acc = torch.bmm(acc, xd) * scale
    return acc


def phase_bdot(bdot, device):
    """The batched-dot kernel against its plain version (and, at
    "highest", the float64 chain) at every h and precision, the ragged N
    and n_dots in BDOT_DOTS; these launches compare and do not count
    toward the path (the probe of phase 18 times both)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    scale = 1e-2
    by = {}
    for h in bdot.SIZES:
        sizes = bdot_sizes(bdot, h)
        xs = {n: torch.randn((n, h, h), generator=gen, device=device) * 0.1
              for n in sizes}
        oracle = {(n, d): chain64(x, d, scale) for n, x in xs.items()
                  for d in BDOT_DOTS if n}
        for precision in bdot.PASSES:
            worst = dict(max_abs_err=0.0, rel_err=0.0)
            for n, x in xs.items():
                for n_dots in BDOT_DOTS:
                    tag = f"bdot h={h} {precision} N={n} dots={n_dots}"
                    got = bdot.bdot(x, n_dots, scale, precision)
                    want = bdot.bdot_ref(x, n_dots, scale, precision)
                    torch.cuda.synchronize()
                    check(got.shape == x.shape, f"{tag}: shape {got.shape}")
                    check(bool(torch.isfinite(got).all()), f"{tag}: nonfinite")
                    if n == 0:
                        continue
                    err = float((got - want).abs().max())
                    rel = err / float(want.abs().max())
                    check(rel <= BDOT_REL_TOL[precision],
                          f"{tag}: rel err {rel} > {BDOT_REL_TOL[precision]}")
                    worst["max_abs_err"] = max(worst["max_abs_err"], err)
                    worst["rel_err"] = max(worst["rel_err"], rel)
                    if precision == "highest":
                        f64 = oracle[n, n_dots]
                        rel64 = float((got.double() - f64).abs().max()
                                      / f64.abs().max())
                        check(rel64 <= BDOT_F64_TOL, f"{tag}: rel err "
                              f"{rel64} against float64 > {BDOT_F64_TOL}")
                        worst["f64_rel_err"] = max(
                            worst.get("f64_rel_err", 0.0), rel64)
            by.setdefault(h, {})[precision] = worst
            f64_part = (f", {worst['f64_rel_err']:.3e} of max|float64 chain|"
                        f" (tol {BDOT_F64_TOL:g})"
                        if precision == "highest" else "")
            say("bdot", f"h={h} {precision}, N in {sizes}, dots in "
                f"{list(BDOT_DOTS)}: max abs err {worst['max_abs_err']:.3e}"
                f", rel err {worst['rel_err']:.3e} of max|plain| (tol "
                f"{BDOT_REL_TOL[precision]:g}){f64_part}")
        del xs, oracle
    return by


@contextlib.contextmanager
def launches_per_epoch(block_chol):
    """Record, for each ``train_epoch`` call while open, the kernel
    launches by r it made and the DeviceData's bucket count (user +
    item buckets)."""
    from safer2_recommender_tpu_torch.models.base import Recommender

    out, epoch = [], Recommender.train_epoch

    def counted(self, dd):
        before = dict(block_chol.LAUNCHES)
        epoch(self, dd)
        out.append(({r: block_chol.LAUNCHES[r] - before[r]
                     for r in block_chol.KERNEL_SIZES},
                    len(dd.by_user) + len(dd.by_item)))

    Recommender.train_epoch = counted
    try:
        yield out
    finally:
        Recommender.train_epoch = epoch


def check_block_launches(tag, per_epoch, dim, bs, r):
    """Every epoch of the reference-order sweep launched the kernel
    (dim / bs) x (user + item buckets) times, all at r, nothing else.
    Returns the launches of one epoch."""
    check(bool(per_epoch), f"{tag}: no epoch was recorded")
    for i, (launches, buckets) in enumerate(per_epoch):
        want = {k: (dim // bs) * buckets if k == r else 0 for k in launches}
        check(launches == want, f"{tag} epoch {i}: kernel launches by r "
              f"{launches}, want {want} ((dim / bs) x {buckets} buckets)")
    return per_epoch[0][0][r]


@contextlib.contextmanager
def grad_launches_per_epoch():
    """Set the gather-matvec kernel's launch count to 0 and record, for
    each ``train_epoch`` call while open, its launches and the
    DeviceData's bucket count (user + item buckets)."""
    from safer2_recommender_tpu_torch.models.base import Recommender
    from safer2_recommender_tpu_torch.ops import grad_gather

    out, epoch = [], Recommender.train_epoch

    def counted(self, dd):
        before = grad_gather.LAUNCHES
        epoch(self, dd)
        out.append((grad_gather.LAUNCHES - before,
                    len(dd.by_user) + len(dd.by_item)))

    grad_gather.LAUNCHES = 0
    Recommender.train_epoch = counted
    try:
        yield out
    finally:
        Recommender.train_epoch = epoch


def check_grad_launches(tag, per_epoch, routed: bool) -> int:
    """Every epoch launched the gather-matvec kernel once a bucket
    (``routed``: CVaR-MF on the card) or never, and nothing outside the
    epochs launched it. Returns the launches."""
    from safer2_recommender_tpu_torch.ops import grad_gather

    check(bool(per_epoch), f"{tag}: no epoch was recorded")
    for i, (launches, buckets) in enumerate(per_epoch):
        want = buckets if routed else 0
        check(launches == want, f"{tag} epoch {i}: {launches} gather-matvec "
              f"launches, want {want} ({buckets} buckets)")
    total = sum(n for n, _ in per_epoch)
    check(grad_gather.LAUNCHES == total, f"{tag}: {grad_gather.LAUNCHES} "
          f"gather-matvec launches, {total} of them in epochs")
    return total


def phase_grad_gather(device) -> list:
    """Phase 33: the probe's checks and times at the MSD-shape buckets."""
    import torch

    from safer2_recommender_tpu_torch.ops import grad_gather
    from safer2_recommender_tpu_torch.probes import grad_gather as gg_probe

    grad_gather.LAUNCHES = 0
    rows = gg_probe.run(device=device)
    for row in rows:
        check(row["ok"], f"grad_gather {row['side']} {row['label']} "
              f"[{row['rows']} x {row['width']}]: max rel err "
              f"{row['max_rel_err']:.3e} > {gg_probe.CHECK_TOL:g}")
    check(any(r["side"] == "item" and r["splits"] > 1 for r in rows),
          "grad_gather: no split item bucket among the checked")
    check(grad_gather.LAUNCHES > 0, "grad_gather: the kernel never launched")
    say("grad_gather", f"{len(rows)} MSD-shape buckets, both sides, kernel "
        f"against the plain route within {gg_probe.CHECK_TOL:g} of the "
        f"step (largest {max(r['max_rel_err'] for r in rows):.3e}); "
        f"{grad_gather.LAUNCHES} launches")
    torch.cuda.empty_cache()
    return rows


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
    a full eigh every sweep at the default eig_refresh_tol, the r = 8..64
    kernel launches they make; then a short run at the JAX package's
    tolerance, which takes its warm refresh."""
    import torch

    from safer2_recommender_tpu_torch import probes
    from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
    from safer2_recommender_tpu_torch.probes import cuda_ms

    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    with probes.recorded_chol_shapes() as shapes:
        res = train(cli, 512, DIM512_EPOCHS)
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
    check(paths["refresh_warm"] == 0,
          f"dim 512: a warm refresh at the default eig_refresh_tol: {paths}")
    check(all(launches[r] > 0 for r in block_chol.KERNEL_SIZES),
          f"dim 512: no kernel launch at some r: {launches}")
    say("dim512", f"ML-1M SAFER2 dim 512, {DIM512_EPOCHS} epochs: NDCG@20 "
        f"{ndcg20:.4f} "
        f"(gate {NDCG20_MIN}); mean dual weight "
        f"{[round(w, 4) for w in res.mean_weights]}; epoch ms "
        f"{res.epoch_ms}; solve paths (padded rows; refreshes) {paths}; "
        f"kernel launches by r {launches}; largest kernel shape "
        f"{list(max(shapes, key=lambda s: s[0] * s[1] * s[2]))}; peak "
        f"device memory {peak} B")
    # the JAX package's branch: a short run at its tolerance
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    res_jax = train(cli, 512, DIM512_JAX_TOL_EPOCHS, args=README_ARGS + [
        "--eig_refresh_tol", str(JAX_EIG_REFRESH_TOL)])
    jax_tol = dict(paths=dict(woodbury.SOLVE_PATHS),
                   launches=dict(block_chol.LAUNCHES),
                   ndcg20=float(res_jax.metrics.mean_ndcg()[2]),
                   mean_weights=res_jax.mean_weights,
                   epoch_ms=res_jax.epoch_ms)
    check(finite_tables(res_jax.model.state),
          "dim 512 at tol 0.08: nonfinite tables")
    check(jax_tol["paths"]["refresh_warm"] > 0,
          f"dim 512 at tol {JAX_EIG_REFRESH_TOL}: no warm refresh: "
          f"{jax_tol['paths']}")
    check(jax_tol["ndcg20"] >= NDCG20_MIN,
          f"dim 512 at tol {JAX_EIG_REFRESH_TOL}: NDCG@20 "
          f"{jax_tol['ndcg20']} < {NDCG20_MIN}")
    check_dual(res_jax, f"dim 512 at tol {JAX_EIG_REFRESH_TOL}")
    say("dim512", f"the same at the JAX package's --eig_refresh_tol "
        f"{JAX_EIG_REFRESH_TOL}, {DIM512_JAX_TOL_EPOCHS} epochs: NDCG@20 "
        f"{jax_tol['ndcg20']:.4f}; mean dual weight "
        f"{[round(w, 4) for w in res_jax.mean_weights]}; epoch ms "
        f"{res_jax.epoch_ms}; solve paths (padded rows; refreshes) "
        f"{jax_tol['paths']}")
    del res_jax
    # the two eigh branches on the trained model's own Gramian and basis
    # (tol 1 forces the warm one); outside the counted run
    state = res.model.state
    eigh_ms = {
        "cold": cuda_ms(lambda: woodbury.sym_eigh(state.item_gramian)),
        "warm": cuda_ms(lambda: woodbury.refresh_eigh(
            state.item_gramian, state.eig_qu, 1.0))}
    orth = basis_orth(state, "dim512")
    say("dim512", f"eigh of the [512, 512] Gramian: cold (woodbury.sym_eigh)"
        f" {eigh_ms['cold']:.3f} ms, warm refresh (4 x [128, 128] blocks) "
        f"{eigh_ms['warm']:.3f} ms; the carried bases after the last epoch"
        f": ||Q^T Q - I||_F {orth} (tol {BASIS_ORTH_TOL:g})")
    block_chol.reset_launches()
    serve = phase_serve(res.model, 1, "dim512")
    return dict(res=res, launches=launches, shapes=shapes, paths=paths,
                serve=serve, serve_launches=block_chol.total_launches(),
                eigh_ms=eigh_ms, basis_orth=orth, peak_bytes=peak,
                jax_tol=jax_tol)


def basis_orth(state, tag: str) -> dict:
    """||Q^T Q - I||_F (float64) of the user- and item-side eigenbases a
    model carries from epoch to epoch, each within BASIS_ORTH_TOL."""
    from safer2_recommender_tpu_torch.probes import eigh

    out = {side: eigh.orthogonality(q) for side, q in
           (("user", state.eig_qu), ("item", state.eig_qv))}
    check(all(v <= BASIS_ORTH_TOL for v in out.values()),
          f"{tag}: a carried eigenbasis is not orthogonal: {out}")
    return out


def phase_synth(block_chol, woodbury, device, workload, setup_s, epochs=2):
    """The library API on the MSD-shaped synthetic workload (50k x 40k,
    dim 512) at the MSD config (bench.py's north star): finite tables and
    rows through the wide (column-chunked) assembly; epoch ms and peak
    device memory. ``workload`` is ``(Dataset, DeviceData, Config)``."""
    import torch

    from safer2_recommender_tpu_torch import get_model, probes

    ds, dd, cfg = workload
    model = get_model("safer2", cfg, ds.num_users, ds.num_items,
                      device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    epoch_ms, weights = [], []
    with probes.recorded_chol_shapes() as shapes:
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
    orth = basis_orth(model.state, "synth50k")
    say("synth50k", f"{ds.num_users} users x {ds.num_items} items, "
        f"{ds.nnz} tuples, dim {cfg.dim}, {epochs} epochs: first epoch "
        f"{epoch_ms[0]} ms, then {epoch_ms[1:]} ms (synchronized host "
        f"clock); data + bucketing {setup_s:.1f} s; mean dual weight "
        f"{weights}; solve paths (padded rows; refreshes) {paths}; kernel "
        f"launches by r {launches}; peak device memory {peak} B; the "
        f"carried bases after the last epoch: ||Q^T Q - I||_F {orth} (tol "
        f"{BASIS_ORTH_TOL:g})")
    return dict(epoch_ms=epoch_ms, paths=paths, launches=launches,
                peak_bytes=peak, shapes=shapes, model=model,
                basis_orth=orth)


def phase_refresh(block_chol, device, workload) -> dict:
    """[refresh]: probes/refresh.py on ML-1M (SAFER2) and the 50k
    ``workload`` (SAFER2, iALS, iALS++) at dim 512: the JAX package's
    warm refresh against the default full eigh from the same states;
    the probe's checks and phase 9's quality gates at both
    tolerances."""
    from safer2_recommender_tpu_torch.probes import refresh

    block_chol.reset_launches()
    rows = refresh.run(device, ("ml1m", "synth50k"),
                       data={"synth50k": workload})
    launches = dict(block_chol.LAUNCHES)
    for row in rows:
        for line in refresh.describe(row):
            say("refresh", line)
    bad = [b for row in rows for b in refresh.check(row)]
    check(not bad, f"refresh: {bad}")
    for tol, q in rows[0]["quality"].items():
        check(q["ndcg20"] >= NDCG20_MIN,
              f"refresh: ML-1M at tol {tol}: NDCG@20 {q['ndcg20']}")
        check(all(abs(w - ALPHA) <= DUAL_TOL for w in q["mean_weight"]),
              f"refresh: ML-1M at tol {tol}: mean dual weight "
              f"{q['mean_weight']} left {ALPHA} +/- {DUAL_TOL}")
    check(sum(launches.values()) > 0, "refresh: no chol_inverse launch")
    return dict(rows=rows, launches=launches)


def phase_models(cli, block_chol, ckpt_root):
    """The other five models through the CLI on ML-1M at dim 32 (block 8
    for the ++ models), at the reference tests' configs, each saving its
    checkpoint under ``ckpt_root/<name>``: the quality gates, finite
    tables on the card, and the kernel launches by r. Returns the
    readings and each run's trained model."""
    out, trained = {}, {}
    for name, (args, epochs) in MODEL_RUNS.items():
        block_chol.reset_launches()
        with grad_launches_per_epoch() as per_epoch:
            res = train(cli, 32, epochs, ["--model_name", name] + args,
                        ckpt=os.path.join(ckpt_root, name))
        grad = check_grad_launches(f"{name} dim 32", per_epoch,
                                   name == "cvar_mf")
        launches = dict(block_chol.LAUNCHES)
        state = res.model.state
        check(res.model.name == name, f"{name}: got a {res.model.name}")
        check(state.user_emb.is_cuda and state.item_emb.is_cuda,
              f"{name}: model tables are not on the GPU")
        check(finite_tables(state), f"{name}: nonfinite tables")
        check(sum(launches.values()) > 0,
              f"{name}: the kernel was never launched")
        ndcg20 = float(res.metrics.mean_ndcg()[2])
        check(ndcg20 >= NDCG20_MIN, f"{name}: NDCG@20 {ndcg20} < {NDCG20_MIN}")
        if name == "safer2pp":
            check_dual(res, name)
        say("models", f"ML-1M {name} dim 32, {epochs} epochs: NDCG@20 "
            f"{ndcg20:.4f} (gate {NDCG20_MIN}); mean dual weight, last 3 "
            f"epochs {[round(w, 4) for w in res.mean_weights[-3:]]}"
            + (f" (gate {ALPHA} +/- {DUAL_TOL}, every epoch)"
               if name == "safer2pp" else "")
            + f"; epoch ms {res.epoch_ms[:10]}; kernel launches by r "
            f"{launches}; gather-matvec launches {grad} ({per_epoch[0][1]} "
            f"buckets an epoch)")
        out[name] = dict(ndcg20=ndcg20, epoch_ms=res.epoch_ms,
                         launches=launches, grad_gather_launches=grad,
                         mean_weights=res.mean_weights[-3:])
        trained[name] = res.model
    return out, trained


def longest_histories(ds, n: int):
    """The histories of the ``n`` users of ``ds`` with the most items, as
    a Dataset (ties: the lower id first)."""
    import numpy as np

    from safer2_recommender_tpu_torch.data.dataset import Dataset

    sizes = np.bincount(ds.user_ids, minlength=ds.num_users)
    top = np.argsort(-sizes, kind="stable")[:n]
    m = np.isin(ds.user_ids, top)
    return Dataset(ds.user_ids[m], ds.item_ids[m]), sizes[top]


def phase_synth_models(block_chol, woodbury, device, workload, wave):
    """This slice's path at full width: each of SYNTH_MODELS through the
    library API on the 50k x 40k workload at the MSD config (dim 512,
    block 64): initialize, one warm-up epoch, two timed epochs
    (synchronized host clock); for the ++ models then one recommend()
    batch of the 256 users with the longest histories, whose fold-in runs
    ``eval_fold_in_epochs`` blockwise sweeps over every bucket wider than
    dim / 2. ``wave[r]`` is the systems the card holds at once."""
    import torch

    from safer2_recommender_tpu_torch import get_model, probes

    ds, dd, cfg = workload
    hist, sizes = longest_histories(ds, 256)
    r_blk = cfg.block_size      # the ++ models' block solves: r = 64
    out = {}
    for name in SYNTH_MODELS:
        model = get_model(name, cfg, ds.num_users, ds.num_items,
                          device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        block_chol.reset_launches()
        woodbury.reset_solve_paths()
        epoch_ms, fold = [], None
        with probes.recorded_chol_shapes() as shapes:
            model.initialize(dd)
            with grad_launches_per_epoch() as per_epoch:
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.train_epoch(dd)
                    torch.cuda.synchronize()
                    epoch_ms.append((time.perf_counter() - t0) * 1000)
            grad = check_grad_launches(f"{name} at 50k", per_epoch,
                                       name == "cvar_mf")
            train_launches = dict(block_chol.LAUNCHES)
            train_paths = dict(woodbury.SOLVE_PATHS)
            if name in ("safer2pp", "ialspp"):
                woodbury.reset_solve_paths()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                users, ids = model.recommend(hist, k=10)
                torch.cuda.synchronize()
                fold = dict(
                    ms=(time.perf_counter() - t0) * 1000,
                    paths=dict(woodbury.SOLVE_PATHS),
                    launches={r: block_chol.LAUNCHES[r] - train_launches[r]
                              for r in block_chol.KERNEL_SIZES})
                check(ids.shape == (256, 10) and users.size == 256,
                      f"{name} fold-in: shape {ids.shape}")
                check(bool(((ids >= 0) & (ids < ds.num_items)).all()),
                      f"{name} fold-in: item id out of range")
                check(fold["launches"][r_blk] > 0
                      and fold["paths"]["block"] > 0,
                      f"{name} fold-in: no blockwise r = {r_blk} solve: "
                      f"{fold}")
        peak = torch.cuda.max_memory_allocated()
        launches = dict(block_chol.LAUNCHES)
        check(len(shapes) == sum(launches.values()),
              f"{name}: launches do not match calls")
        check(finite_tables(model.state), f"{name} at 50k: nonfinite tables")
        check(train_paths["wide"] > 0, f"{name}: no wide rows: {train_paths}")
        if name in ("safer2pp", "ialspp"):
            check(train_launches[r_blk] > 0 and train_paths["block"] > 0,
                  f"{name}: no r = {r_blk} block solve in training: "
                  f"{train_launches} {train_paths}")
        by_r = probes.launch_histogram(shapes, wave)
        under = {r: h["below_one_wave"] for r, h in by_r.items()}
        say("synth50k-models", f"{name}, dim {cfg.dim}, block "
            f"{cfg.block_size}: warm-up epoch {epoch_ms[0]:.1f} ms, then "
            f"{[round(t, 1) for t in epoch_ms[1:]]} ms (synchronized host "
            f"clock); initialize + 3 epochs: solve paths (padded rows; "
            f"refreshes) {train_paths}; kernel launches by r "
            f"{train_launches}"
            + (f"; fold-in of the 256 longest histories ({int(sizes.min())}"
               f"-{int(sizes.max())} items) + scoring {fold['ms']:.1f} ms, "
               f"paths {fold['paths']}, launches by r {fold['launches']}"
               if fold else "")
            + f"; launches under one wave by r {under} of {launches}; "
            f"gather-matvec launches {grad} ({per_epoch[0][1]} buckets an "
            f"epoch); peak device memory {peak} B")
        out[name] = dict(epoch_ms=epoch_ms, paths=train_paths,
                         launches=train_launches, fold_in=fold,
                         grad_gather_launches=grad,
                         total_launches=sum(launches.values()),
                         launch_histogram=by_r, peak_bytes=peak,
                         shapes=shapes)
        if name == "safer2pp":
            out[name]["model"] = model    # served by phase 16
        del model
        torch.cuda.empty_cache()
    return out


def phase_interleaved(cli, block_chol, woodbury, ckpt_root):
    """The reference-order ++ sweep through the CLI: SAFER2++ on ML-1M at
    dim 512, block 64, the README's MSD config, INTERLEAVED_EPOCHS epochs
    (then the same run in frozen order), and iALS++ at dim 32, block 8,
    at the reference tests' config, 10 epochs; both save checkpoints
    for the server phase. Gates: NDCG@20, SAFER2++'s dual weight after
    every epoch, finite tables, and (dim / bs) x buckets launches at
    r = bs in every epoch."""
    import torch

    from safer2_recommender_tpu_torch import probes

    out, trained = {}, {}
    runs = (
        ("safer2pp_interleaved", 512, INTERLEAVED_EPOCHS,
         ["--model_name", "safer2pp", "--block_size", "64"] + MSD_ARGS, 64),
        ("ialspp_interleaved", 32, 10,
         ["--model_name", "ialspp"] + MODEL_RUNS["ialspp"][0], 8))
    for tag, dim, epochs, args, bs in runs:
        torch.cuda.reset_peak_memory_stats()
        block_chol.reset_launches()
        woodbury.reset_solve_paths()
        with probes.recorded_chol_shapes() as shapes, \
                launches_per_epoch(block_chol) as per_epoch:
            res = train(cli, dim, epochs, args + INTERLEAVED,
                        ckpt=os.path.join(ckpt_root, tag))
        launches = dict(block_chol.LAUNCHES)
        paths = dict(woodbury.SOLVE_PATHS)
        peak = torch.cuda.max_memory_allocated()
        model = res.model
        check(model.cfg.block_interleaved and not model._loss_lags_one_epoch,
              f"{tag}: the reference order did not engage")
        check(finite_tables(model.state), f"{tag}: nonfinite tables")
        ndcg20 = float(res.metrics.mean_ndcg()[2])
        check(ndcg20 >= NDCG20_MIN, f"{tag}: NDCG@20 {ndcg20} < {NDCG20_MIN}")
        if model.name == "safer2pp":
            check_dual(res, tag, last_only=True)
        cfg = model.cfg
        per = check_block_launches(tag, per_epoch, cfg.dim, cfg.block_size,
                                   bs)
        check(len(shapes) == sum(launches.values()),
              f"{tag}: launches do not match calls")
        out[tag] = dict(ndcg20=ndcg20, epoch_ms=res.epoch_ms,
                        mean_weights=res.mean_weights[-3:],
                        launches_per_epoch=per, launches=launches,
                        paths=paths, peak_bytes=peak, shapes=shapes,
                        recall20=float(res.metrics.mean_recall()[2]))
        trained[tag] = model
        say("interleaved", f"ML-1M {model.name} --block_interleaved, dim "
            f"{cfg.dim}, block {cfg.block_size}, {len(res.epoch_ms)} epochs:"
            f" NDCG@20 {ndcg20:.4f} "
            f"(gate {NDCG20_MIN}); Rec@20 {out[tag]['recall20']:.4f}; "
            f"mean dual weight, last 3 epochs "
            f"{[round(w, 4) for w in res.mean_weights[-3:]]}"
            + (f" (gate {ALPHA} +/- {DUAL_TOL} after the last epoch; "
               f"every epoch {[round(w, 4) for w in res.mean_weights]})"
               if model.name == "safer2pp" else "")
            + f"; epoch ms first {res.epoch_ms[0]}, then median "
            f"{median(res.epoch_ms[1:])} (min {min(res.epoch_ms[1:])}, max "
            f"{max(res.epoch_ms[1:])}); "
            f"launches per epoch {per} at r = {bs} = "
            f"{cfg.dim // cfg.block_size} blocks x "
            f"{per_epoch[0][1]} buckets (every epoch); whole run incl. eval "
            f"by r {launches}; rows by path {paths}; peak device memory "
            f"{peak} B")
    # the same SAFER2++ run in frozen order, for its NDCG@20
    tag, dim, epochs, args, _ = runs[0]
    frozen = train(cli, dim, epochs, args)
    check(finite_tables(frozen.model.state), "frozen order: nonfinite")
    f_ndcg = float(frozen.metrics.mean_ndcg()[2])
    out[tag]["frozen_ndcg20"] = f_ndcg
    out[tag]["frozen_epoch_ms"] = frozen.epoch_ms
    say("interleaved", f"ML-1M safer2pp dim {dim}, block 64, MSD config, "
        f"{epochs} epochs: NDCG@20 {out[tag]['ndcg20']:.4f} in the "
        f"reference's order against {f_ndcg:.4f} in frozen order (frozen "
        f"epoch ms median {median(frozen.epoch_ms)}); the "
        f"reference C++ 0.2790-0.2801, the JAX package 0.2794 / 0.2638 "
        f"(BASELINE.md)")
    del frozen
    return out, trained


def phase_interleaved50k(block_chol, woodbury, device, workload, wave):
    """SAFER2++ in the reference's order through the library API on the
    50k workload at the MSD config (dim 512, block 64): initialize, one
    warm-up epoch, two timed ones (synchronized host clock); rows through
    the column-chunked route, launches by r and N against one wave."""
    import torch

    from safer2_recommender_tpu_torch import get_model, probes

    ds, dd, cfg = workload
    cfg = cfg.replace(block_interleaved=True)
    model = get_model("safer2pp", cfg, ds.num_users, ds.num_items,
                      device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    epoch_ms, weights = [], []
    with probes.recorded_chol_shapes() as shapes, \
            launches_per_epoch(block_chol) as per_epoch:
        model.initialize(dd)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.train_epoch(dd)
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t0) * 1000)
            weights.append(model.get_mean_weight())
    peak = torch.cuda.max_memory_allocated()
    paths = dict(woodbury.SOLVE_PATHS)
    launches = dict(block_chol.LAUNCHES)
    check(finite_tables(model.state), "interleaved50k: nonfinite tables")
    check(paths["wide"] > 0, f"interleaved50k: no wide rows: {paths}")
    per = check_block_launches("interleaved50k", per_epoch, cfg.dim,
                               cfg.block_size, cfg.block_size)
    check(len(shapes) == sum(launches.values()),
          "interleaved50k: launches do not match calls")
    by_r = probes.launch_histogram(shapes, wave)
    say("interleaved50k", f"safer2pp --block_interleaved, {ds.num_users} "
        f"users x {ds.num_items} items, dim {cfg.dim}, block "
        f"{cfg.block_size}, MSD config: warm-up epoch {epoch_ms[0]:.1f} ms, "
        f"then {[round(t, 1) for t in epoch_ms[1:]]} ms (synchronized host "
        f"clock); mean dual weight {[round(w, 4) for w in weights]}; rows "
        f"by path, 3 epochs {paths}; launches per epoch {per} at r = "
        f"{cfg.block_size} = {cfg.dim // cfg.block_size} blocks x "
        f"{per_epoch[0][1]} buckets; launches by r and N against one wave "
        f"{json.dumps(by_r)}; peak device memory {peak} B")
    return dict(epoch_ms=epoch_ms, paths=paths, launches=launches,
                launches_per_epoch=per, launch_histogram=by_r,
                peak_bytes=peak, shapes=shapes, mean_weights=weights)


def phase_cg(cli, block_chol, ckpt_root, direct32_ms):
    """SAFER2 --use_cg through the CLI: ML-1M dim 32 at the README config
    for 10 epochs (NDCG@20 and the dual gate) and dim 512 at the MSD
    config for CG_EPOCHS_DIM512 epochs (finite tables and the dual gate),
    each saving a checkpoint for the server phase; zero chol_inverse
    launches on both (every solve, the evaluation's included, was CG);
    epoch ms beside the same runs without --use_cg (dim 32: phase 6's)."""
    out, trained = {}, {}
    for tag, dim, epochs, args in (
            ("safer2_cg_dim32", 32, 10, README_ARGS),
            ("safer2_cg_dim512", 512, CG_EPOCHS_DIM512,
             ["--model_name", "safer2"] + MSD_ARGS)):
        block_chol.reset_launches()
        res = train(cli, dim, epochs, args + ["--use_cg", "1"],
                    ckpt=os.path.join(ckpt_root, tag))
        launches = dict(block_chol.LAUNCHES)
        check(res.model.cfg.use_cg, f"{tag}: use_cg did not reach the model")
        check(sum(launches.values()) == 0,
              f"{tag}: chol_inverse was launched {launches}: not all CG")
        check(finite_tables(res.model.state), f"{tag}: nonfinite tables")
        check_dual(res, tag, last_only=dim == 512)
        ndcg20 = float(res.metrics.mean_ndcg()[2])
        if dim == 32:
            check(ndcg20 >= NDCG20_MIN,
                  f"{tag}: NDCG@20 {ndcg20} < {NDCG20_MIN}")
            direct_ms = direct32_ms
        else:
            direct_ms = train(cli, dim, epochs, args).epoch_ms
        out[tag] = dict(ndcg20=ndcg20, epoch_ms=res.epoch_ms,
                        direct_epoch_ms=direct_ms, launches=launches,
                        mean_weights=res.mean_weights)
        trained[tag] = res.model
        say("cg", f"ML-1M safer2 --use_cg 1, dim {dim}, {epochs} epochs: "
            f"NDCG@20 {ndcg20:.4f}" + (f" (gate {NDCG20_MIN})" if dim == 32
                                       else "")
            + f"; mean dual weight "
            f"{[round(w, 4) for w in res.mean_weights]} (gate {ALPHA} +/- "
            f"{DUAL_TOL}, {'the last' if dim == 512 else 'every'} epoch); "
            f"chol_inverse launches {launches}; epoch ms "
            f"{res.epoch_ms} against {direct_ms} without --use_cg")
    return out, trained


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def user_batches(ds, rng, sizes):
    """Request batches of ``ds``: for each size, the histories of that
    many of its users, drawn without replacement."""
    import numpy as np

    from safer2_recommender_tpu_torch.data.dataset import Dataset

    users = np.unique(ds.user_ids)
    out = []
    for n in sizes:
        sel = rng.choice(users, size=min(int(n), users.size), replace=False)
        m = np.isin(ds.user_ids, sel)
        out.append(Dataset(ds.user_ids[m], ds.item_ids[m]))
    return out


def restore_fresh(trained, ckpt_dir):
    """A fresh model of ``trained``'s kind restored from ``ckpt_dir`` with
    its id sidecar; no DeviceData is built."""
    from safer2_recommender_tpu_torch import CheckpointManager, get_model

    fresh = get_model(trained.name, trained.cfg, trained.num_users,
                      trained.num_items, device=trained.device)
    state, epoch, meta = CheckpointManager(ckpt_dir).restore_with_meta(
        fresh.state, generator=fresh.generator)
    check(state is not None and meta is not None,
          f"{trained.name}: no checkpoint with a sidecar in {ckpt_dir}")
    fresh.state = state
    fresh.load_checkpoint_meta(meta)
    return fresh, epoch


def check_served(tag, model, batch, got, want) -> int:
    """Server ids ``got`` against recommend()'s ``want`` on ``batch``:
    the same users, no history item, and the same ids but for near-tie
    swaps (``probes/serving_scale.py::tie_rows``: items whose scores
    under recommend()'s own fold-in lie within TIE_TOL of the row's top
    score). Returns the rows with such a swap."""
    import numpy as np

    from safer2_recommender_tpu_torch.probes import serving_scale

    (gu, gids), (wu, wids) = got, want
    check(np.array_equal(gu, wu), f"{tag}: users differ from recommend()")
    check(gids.shape == wids.shape, f"{tag}: shape {gids.shape}")
    out_of_range, in_history = serving_scale.bad_ids(batch, gu, gids,
                                                     model.num_items)
    check(out_of_range == 0, f"{tag}: item id out of range")
    check(in_history == 0, f"{tag}: a history item was recommended")
    rows, ties = serving_scale.tie_rows(model, batch, gids, wids)
    check(ties.size == rows.size, f"{tag}: {rows.size - ties.size} of "
          f"{gids.shape[0]} rows differ from recommend() by more than a "
          f"near-tie swap (TIE_TOL {serving_scale.TIE_TOL:g})")
    return int(ties.size)


def p50_ms(fn, device, repeats=P50_REPEATS):
    import numpy as np

    fn()
    times = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1000)
    return float(np.median(times))


def graph_matches_eager(srv, batch) -> bool:
    """Serve ``batch``, then run its program's callable eagerly on the
    same static inputs: the replayed graph's ids must be bit-identical."""
    import torch

    from safer2_recommender_tpu_torch.utils.device import f32_matmul

    _, shapes, _ = next(srv._pack(batch.user_ids, batch.item_ids))
    srv.recommend(batch)
    prog = srv.programs()[shapes]
    graph_ids = (prog.out if prog.out is not None else prog.fn()).clone()
    with f32_matmul():
        eager_ids = prog.fn()
    return bool(torch.equal(graph_ids, eager_ids))


def pool_bytes(srv):
    """Bytes reserved in the Server's graph memory pool (None where the
    allocator's snapshot does not name pools)."""
    import torch

    if srv._pool is None:
        return 0
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(srv._pool))


def serve_model(tag, model, server_model, batches, b64, block_chol, device,
                approx_overlap=False):
    """One model through a Server: the first pass builds the programs
    (launch counts set to 0 just before it and read after, the kernel's
    shapes recorded), the second is timed; then the checks of
    ``check_served``, graph against eager, no new program, the stream;
    p50 at batch 64 from the graph and from ``recommend``."""
    import numpy as np
    import torch

    from safer2_recommender_tpu_torch import Server, probes

    srv = Server(server_model, k=10)
    block_chol.reset_launches()
    with probes.recorded_chol_shapes() as shapes:
        first = [srv.recommend(b) for b in batches]
    sync(device)
    launches = dict(block_chol.LAUNCHES)
    compiles = srv.num_compiles
    progs = srv.programs().values()
    if model.cfg.use_cg:
        # CG fold-ins: captured with no host read, no kernel launched
        check(sum(launches.values()) == 0,
              f"{tag}: the CG fold-in launched chol_inverse {launches}")
    else:
        check(sum(launches.values()) > 0,
              f"{tag}: chol_inverse was never launched on the served path")
    check(all(p.graph is not None for p in progs),
          f"{tag}: a program holds no CUDA graph")
    # each program's warm-up ran what its capture recorded; every replay
    # ran it again
    want_launches = {r: sum(p.capture_launches[r] * (1 + p.replays)
                            for p in progs)
                     for r in block_chol.KERNEL_SIZES}
    check(launches == want_launches, f"{tag}: launches {launches}, but the "
          f"warm-ups and replays ran {want_launches}")
    check(len(shapes) == 2 * sum(sum(p.capture_launches.values())
                                 for p in progs),
          f"{tag}: {len(shapes)} wrapper calls for the warm-ups and "
          f"captures")
    second, batch_ms = [], []
    for b in batches:
        sync(device)
        t0 = time.perf_counter()
        second.append(srv.recommend(b))
        batch_ms.append((time.perf_counter() - t0) * 1000)
    secs = sum(batch_ms) / 1000
    served = sum(u.size for u, _ in second)
    check(srv.num_compiles == compiles,
          f"{tag}: a new graph after the first pass ({compiles} -> "
          f"{srv.num_compiles})")
    for (u1, i1), (u2, i2) in zip(first, second):
        check(np.array_equal(u1, u2) and np.array_equal(i1, i2),
              f"{tag}: a replay differs from the first pass")
    streamed = list(srv.recommend_stream(batches))
    check(len(streamed) == len(batches) and all(
        np.array_equal(a[1], b[1]) for a, b in zip(streamed, first)),
          f"{tag}: recommend_stream differs from the loop")
    rec_ms, ties = [], 0
    for i, (b, got) in enumerate(zip(batches, first)):
        sync(device)
        t0 = time.perf_counter()
        want = model.recommend(b, k=10)
        sync(device)
        rec_ms.append((time.perf_counter() - t0) * 1000)
        ties += check_served(f"{tag} batch {i}", model, b, got, want)
    check(graph_matches_eager(srv, b64),
          f"{tag}: the graph's ids differ from its program run eagerly")
    check(srv.num_compiles >= compiles, f"{tag}: programs lost")
    srv_p50 = p50_ms(lambda: srv.recommend(b64), device)
    rec_p50 = p50_ms(lambda: model.recommend(b64, k=10), device)
    out = dict(
        users=int(served), users_per_s=served / secs,
        batch_users=[int(u.size) for u, _ in first], batch_ms=batch_ms,
        p50_ms_batch64=srv_p50, recommend_p50_ms_batch64=rec_p50,
        recommend_ms=rec_ms, rows=int(sum(u.size for u, _ in first)),
        near_tie_rows=ties,
        graphs=srv.num_compiles, replays=srv.replays,
        launches=launches, shapes=shapes,
        per_capture={str(list(k)): p.capture_launches
                     for k, p in srv.programs().items()},
        pool_bytes=pool_bytes(srv) if device.type == "cuda" else None)
    # the exact Server's graph pool goes before the approx one is built
    # (a dim-512 direct fold-in at B = 4096 holds tens of GB); a program
    # refers back to its Server, so only the collector frees them
    del srv
    probes.release_graphs()
    if approx_overlap:
        asrv = Server(server_model, k=10, approx=True)
        ov = [np.mean([np.intersect1d(x, y).size / 10
                       for x, y in zip(asrv.recommend(b)[1], got[1])])
              for b, got in zip(batches, first)]
        out["approx_overlap"] = float(np.mean(ov))
        out["approx_graphs"] = asrv.num_compiles
        del asrv
        probes.release_graphs()
    return out


def describe_served(r) -> str:
    from safer2_recommender_tpu_torch.probes.serving_scale import TIE_TOL

    return (f"{r['users_per_s']:.1f} users/s over batches of "
            f"{r['batch_users']} (second pass, synchronized host clock; ms "
            f"per batch {[round(t, 2) for t in r['batch_ms']]}); "
            f"p50 at batch 64 {r['p50_ms_batch64']:.2f} ms from the graph, "
            f"{r['recommend_p50_ms_batch64']:.2f} ms by recommend(); "
            f"{r['graphs']} graphs, {r['replays']} replays; ids equal to "
            f"recommend() in {r['rows'] - r['near_tie_rows']} of {r['rows']} "
            f"rows, the other {r['near_tie_rows']} a near-tie swap (TIE_TOL "
            f"{TIE_TOL:g}); chol_inverse launches "
            f"of the first pass by r (warm-ups + replays x per capture) "
            f"{r['launches']}, per capture {r['per_capture']}")


def server_batches():
    """Phase 15's requests: SERVE_BATCHES batches of 1-1,000 held-out
    ML-1M users (sizes from SERVE_SEED) and one batch of 64."""
    import numpy as np

    from safer2_recommender_tpu_torch.data.dataset import Dataset

    hist = Dataset.from_csv(os.path.join(ML1M, "validation_tr.csv"))
    rng = np.random.default_rng(SERVE_SEED)
    n_users = np.unique(hist.user_ids).size
    sizes = rng.integers(1, min(1024, n_users) + 1, SERVE_BATCHES)
    batches = user_batches(hist, rng, sizes)
    return batches, user_batches(hist, rng, [64])[0]


def phase_server(trained, ckpt_dirs, block_chol, device):
    """Each ML-1M model restored from its CLI checkpoint into a fresh
    model and served by a Server over SERVE_BATCHES batches of held-out
    users, checked against the trained model's recommend()."""
    batches, b64 = server_batches()
    out = {}
    for name, model in trained.items():
        fresh, epoch = restore_fresh(model, ckpt_dirs[name])
        r = serve_model(f"server {name}", model, fresh, batches, b64,
                        block_chol, device, approx_overlap=True)
        r["restored_epoch"] = epoch
        say("server", f"ML-1M {name} dim {model.cfg.dim}, restored at epoch "
            f"{epoch}: "
            + describe_served(r) + f"; approx=True top-10 overlap with "
            f"the exact {r['approx_overlap']:.4f} ({r['approx_graphs']} "
            f"graphs)")
        out[name] = r
    return out


def run_facts(res, launches, shapes, paths, peak):
    """What phase 19 compares of one ML-1M dim-512 CLI run."""
    return dict(ndcg20=float(res.metrics.mean_ndcg()[2]),
                epoch_ms=res.epoch_ms, median_ms=median(res.epoch_ms[1:]),
                mean_weights=res.mean_weights, launches=launches,
                shapes=sorted(shapes), paths=paths, peak_bytes=peak)


def phase_bf16_ml1m(cli, block_chol, woodbury, f32, ckpt):
    """ML-1M SAFER2 at dim 512 with --compute_dtype bf16 through the CLI,
    beside phase 9's float32 run ``f32`` (``run_facts``): the quality
    gates, and the same kernel launches, shape for shape."""
    import torch

    from safer2_recommender_tpu_torch import probes

    torch.cuda.reset_peak_memory_stats()
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    with probes.recorded_chol_shapes() as shapes:
        res = train(cli, 512, DIM512_EPOCHS, README_ARGS + BF16, ckpt=ckpt)
    bf = run_facts(res, dict(block_chol.LAUNCHES), shapes,
                   dict(woodbury.SOLVE_PATHS),
                   torch.cuda.max_memory_allocated())
    check(res.model.asm_dtype == torch.bfloat16, "bf16: not a bf16 model")
    check(finite_tables(res.model.state), "bf16 dim 512: nonfinite tables")
    check(bf["ndcg20"] >= NDCG20_MIN,
          f"bf16 dim 512: NDCG@20 {bf['ndcg20']} < {NDCG20_MIN}")
    check(abs(bf["ndcg20"] - f32["ndcg20"]) <= BF16_NDCG_TOL,
          f"bf16 dim 512: NDCG@20 {bf['ndcg20']} is more than "
          f"{BF16_NDCG_TOL} from the f32 run's {f32['ndcg20']}")
    check_dual(res, "bf16 dim 512")
    check(sum(bf["launches"].values()) > 0, "bf16 dim 512: no kernel launch")
    check(bf["launches"] == f32["launches"] and bf["shapes"] == f32["shapes"],
          f"bf16 dim 512: kernel launches by r {bf['launches']} differ from "
          f"the f32 run's {f32['launches']} (or their shapes do)")
    for tag, r in (("f32", f32), ("bf16", bf)):
        say("bf16", f"ML-1M SAFER2 dim 512 {tag}, {DIM512_EPOCHS} epochs: "
            f"NDCG@20 {r['ndcg20']:.4f}; epoch ms {r['epoch_ms']} (median "
            f"after the first {r['median_ms']}); mean dual weight "
            f"{[round(w, 4) for w in r['mean_weights']]}; peak device memory "
            f"{r['peak_bytes']} B; solve paths (padded rows; refreshes) "
            f"{r['paths']}; kernel launches by r {r['launches']}")
    say("bf16", f"NDCG@20 bf16 - f32 {bf['ndcg20'] - f32['ndcg20']:+.4f} "
        f"(tol {BF16_NDCG_TOL}); the same {len(bf['shapes'])} kernel "
        f"launches, shape for shape")
    del bf["shapes"]
    return bf, res.model


def phase_bf16_gram(model, dd, device):
    """One 50k item bucket's bf16 Gramian and rhs on the card (the
    largest bucket that is not streamed), by the route gram_route picks,
    against the plain f32 product of the same operands (the weighted
    operand as ``assemble.weight_operand`` forms it for that route); the
    model's user table and dual weights are the operands. Also reported:
    how far the rounded weighted operand moves the Gramian from the exact
    weighted product the CPU route uses."""
    import torch

    from safer2_recommender_tpu_torch.ops import assemble
    from safer2_recommender_tpu_torch.probes import cuda_ms
    from safer2_recommender_tpu_torch.utils.device import f32_matmul

    dim = model.cfg.dim
    b = max((b for b in dd.by_item if not assemble.is_wide(b, dim)),
            key=lambda b: b.n_rows * b.width)
    norm_dual = model._norm_dual(dd, model.state.dual_weight)
    bf = torch.bfloat16
    with f32_matmul():
        emb, _, wt = assemble.gather_history_extra(model.state.user_emb,
                                                   norm_dual, b, bf)
        # the weighted operand the route multiplies: bfloat16 on the
        # "out_dtype" route, the exact product on the "upcast" one
        lhs = assemble.weight_operand(emb, wt[..., None])
        got_a = assemble.row_gramians(emb, wt)
        got_r = assemble.row_sums(emb, wt)
        want_a = torch.bmm(lhs.float().transpose(1, 2), emb.float())
        want_r = (emb * wt[..., None].to(bf)).float().sum(dim=1)
        exact = torch.bmm((emb.float() * wt[..., None].to(bf).float())
                          .transpose(1, 2), emb.float())
        rounded = torch.bmm((emb * wt[..., None].to(bf)).float()
                            .transpose(1, 2), emb.float())
        route = assemble.gram_route(device)
        ms = dict(
            route=cuda_ms(lambda: assemble.row_gramians(emb, wt)),
            plain_f32=cuda_ms(lambda: torch.bmm(
                lhs.float().transpose(1, 2), emb.float())),
            f32_slab=cuda_ms(lambda: assemble.row_gramians(
                emb.float(), wt)))
    torch.cuda.synchronize()
    err_a = float((got_a - want_a).abs().max() / want_a.abs().max())
    err_r = float((got_r - want_r).abs().max() / want_r.abs().max())
    moved = float((rounded - exact).abs().max() / exact.abs().max())
    check(got_a.dtype == got_r.dtype == torch.float32,
          "bf16 gram: not float32 out")
    check(err_a <= GRAM_REL_TOL and err_r <= GRAM_REL_TOL,
          f"bf16 gram: route {route} off the plain f32 product by "
          f"{err_a:.3e} (Gramian) / {err_r:.3e} (rhs) > {GRAM_REL_TOL}")
    say("bf16", f"route {route}: the Gramian and rhs of the 50k item bucket "
        f"[{b.n_rows}, {b.width}, {dim}] from the bf16 slab, against the "
        f"plain f32 product of the same operands: rel err "
        f"{err_a:.3e} / {err_r:.3e} of max|plain| (tol {GRAM_REL_TOL:g}); "
        f"rounding the weighted operand to bfloat16 moves the Gramian "
        f"{moved:.3e} of max from the exact weighted product; ms per "
        f"Gramian: route {ms['route']:.4f}, plain f32 of the operands "
        f"{ms['plain_f32']:.4f}, the f32 path's own {ms['f32_slab']:.4f} "
        f"(CUDA events)")
    return dict(route=route, bucket=[b.n_rows, b.width, dim],
                gram_rel_err=err_a, rhs_rel_err=err_r,
                rounded_operand_moves=moved, ms=ms)


def phase_bf16_synth(block_chol, woodbury, device, workload, f32_models,
                     f32_ms):
    """The 50k workload (MSD config, dim 512) in bf16: SAFER2 and SAFER2++
    (frozen, block 64) through the library API, initialize + 2 epochs
    each, then 2 profiled epochs of each of them and of the f32 models
    of phases 10 and 14 (``f32_models``; ``f32_ms`` their epoch ms)."""
    import torch

    from safer2_recommender_tpu_torch import get_model

    ds, dd, cfg = workload
    out, models = {}, {}
    for name in ("safer2", "safer2pp"):
        model = get_model(name, cfg.replace(compute_dtype="bf16"),
                          ds.num_users, ds.num_items, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        block_chol.reset_launches()
        woodbury.reset_solve_paths()
        epoch_ms, weights = [], []
        model.initialize(dd)
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.train_epoch(dd)
            torch.cuda.synchronize()
            epoch_ms.append((time.perf_counter() - t1) * 1000)
            weights.append(model.get_mean_weight())
        r = dict(epoch_ms=epoch_ms, mean_weights=weights,
                 launches=dict(block_chol.LAUNCHES),
                 paths=dict(woodbury.SOLVE_PATHS),
                 peak_bytes=torch.cuda.max_memory_allocated())
        check(finite_tables(model.state), f"bf16 50k {name}: nonfinite")
        check(sum(r["launches"].values()) > 0,
              f"bf16 50k {name}: no kernel launch")
        check(r["paths"]["wide"] > 0, f"bf16 50k {name}: no wide rows")
        say("bf16", f"50k {name} dim 512 bf16: epoch ms {epoch_ms} (f32 "
            f"{[round(t, 1) for t in f32_ms[name]]}); mean dual weight "
            f"{weights}; peak device memory {r['peak_bytes']} B; solve "
            f"paths {r['paths']}; kernel launches by r {r['launches']}")
        out[name] = r
        models[name] = model
    out["profile"] = {}
    for name in ("safer2", "safer2pp"):
        out["profile"].update(profile_pair(
            f"50k {name}", {"f32": f32_models[name], "bf16": models[name]},
            dd))
    return out, models


def profile_pair(tag, models, dd):
    """Two more epochs of each of ``models`` ({"f32": model, "bf16":
    model}) under torch.profiler (probes/epoch_profile.py): wall ms,
    device busy ms (the union of device intervals), its share, the top
    device operations."""
    from safer2_recommender_tpu_torch.probes import epoch_profile

    out = {}
    for dt, model in models.items():
        wall, busy, ranked, chol = epoch_profile.profile_epochs(model, dd)
        say("bf16", f"{tag} {dt}, 2 epochs under torch.profiler: wall "
            f"{wall:.1f} ms, device busy {busy:.1f} ms "
            f"({100 * busy / wall:.1f}%); chol_inverse "
            f"{sum(c[0] for c in chol):.2f} ms in "
            f"{sum(c[1] for c in chol)} launches; top device ops "
            + "; ".join(f"{ms:.1f} ms x {n} {op[:60]}"
                        for ms, n, op in ranked[:6]))
        out[f"{tag} {dt}"] = dict(
            wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
            top=[dict(ms=ms, count=n, name=op[:120]) for ms, n, op in ranked])
    return out


def phase_profile_dir(cli, block_chol, trace_root):
    """A 2-epoch CLI run (ML-1M, dim 32, README config, bf16) with
    --profile_dir: one trace file, whose device kernels include the
    inverse-Cholesky kernel."""
    import glob

    prof = os.path.join(trace_root, "profile")
    block_chol.reset_launches()
    train(cli, 32, 2, README_ARGS + BF16 + ["--profile_dir", prof])
    launches = block_chol.total_launches()
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    check(len(traces) == 1, f"--profile_dir: trace files {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    chol = [e for e in kernels if "chol_inverse" in e.get("name", "")]
    check(bool(chol), f"--profile_dir: no chol_inverse kernel among the "
          f"trace's {len(kernels)} device kernels")
    names = sorted({re.search(r"chol_inverse\w*(<\d+>)?", e["name"])[0]
                    for e in chol})
    say("bf16", f"--profile_dir: {os.path.basename(traces[0])}, "
        f"{os.path.getsize(traces[0])} B, {len(events)} events, "
        f"{len(kernels)} device kernels, {len(chol)} of them chol_inverse "
        f"({names}); kernel "
        f"launches of the run {launches}")
    return dict(trace_bytes=os.path.getsize(traces[0]),
                kernels=len(kernels), chol_inverse_kernels=len(chol),
                launches=launches)


def phase_server50k(models, ds, block_chol, device):
    """The 50k dim-512 SAFER2 and SAFER2++ models served: the 256 longest
    histories and 1,024 random users, with SAFER2++'s recommend() time on
    the 256."""
    import numpy as np

    rng = np.random.default_rng(SERVE_SEED)
    longest, sizes = longest_histories(ds, 256)
    batches = [longest] + user_batches(ds, rng, [1024])
    b64 = user_batches(ds, rng, [64])[0]
    out = {}
    for name, model in models.items():
        r = serve_model(f"server50k {name}", model, model, batches, b64,
                        block_chol, device)
        say("server50k", f"50k {name} dim {model.cfg.dim}, the 256 longest "
            f"histories "
            f"({int(sizes.min())}-{int(sizes.max())} items) and 1,024 "
            f"random users: " + describe_served(r)
            + f"; recommend() ms per batch {[round(t, 1) for t in r['recommend_ms']]}"
            f"; graph pool {r['pool_bytes']} B")
        out[name] = r
    return out


MESH_RANKS = (2, 8)     # world sizes of [mesh] (b), (c), on the one card
MESH_SYNTH = (50_000, 40_000)     # the synth50k workload's users, items
MESH_MODELS = ("safer2", "safer2pp")   # the ++ model frozen, block 64
# a 2-rank epoch against the one-process epoch: the JAX package's
# sharded-vs-single bound (tests/test_multidevice.py:41-46), atol scaled
# by dim / 8 as the port's parity tests scale it
MESH_RTOL, MESH_ATOL = 5e-3, 5e-5
MESH_DUAL_TOL = 1e-4
MESH_NDCG_TOL = 0.005


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_mesh_cli(cli, block_chol, ndcg512, shapes512):
    """[mesh] (a): ``--distributed 1`` through the CLI in this process,
    torchrun's environment set for one rank (NCCL, world size 1): the
    dim512 run again, its NDCG@20 and launch shapes against phase 9's."""
    import torch.distributed as dist

    from safer2_recommender_tpu_torch import probes

    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    block_chol.reset_launches()
    try:
        with probes.recorded_chol_shapes() as shapes:
            res = train(cli, 512, DIM512_EPOCHS,
                        args=README_ARGS + ["--distributed", "1"])
        mesh = res.model.mesh
        backend = dist.get_backend()
        traffic = mesh.traffic.snapshot()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = dict(block_chol.LAUNCHES)
    ndcg20 = float(res.metrics.mean_ndcg()[2])
    check(mesh.world_size == 1 and backend == "nccl",
          f"mesh (a): world {mesh.world_size}, backend {backend}")
    check(ndcg20 >= NDCG20_MIN and abs(ndcg20 - ndcg512) <= MESH_NDCG_TOL,
          f"mesh (a): NDCG@20 {ndcg20} vs dim512's {ndcg512} "
          f"(tol {MESH_NDCG_TOL})")
    check_dual(res, "mesh (a)")
    check(Counter(shapes) == Counter(shapes512),
          "mesh (a): chol_inverse launch shapes differ from dim512's")
    check(len(shapes) == sum(launches.values()),
          "mesh (a): launches do not match calls")
    from safer2_recommender_tpu_torch.parallel import audit

    say("mesh", f"(a) --distributed 1, NCCL, world size 1, ML-1M SAFER2 "
        f"dim 512, {DIM512_EPOCHS} epochs: NDCG@20 {ndcg20:.4f} (dim512 "
        f"{ndcg512:.4f}); mean dual weight "
        f"{[round(w, 4) for w in res.mean_weights]}; epoch ms "
        f"{res.epoch_ms}; chol_inverse launches {sum(launches.values())} "
        f"by r {launches}, shape for shape dim512's; collectives of the run "
        f"(training + evaluations) {traffic}, "
        f"{audit.total_calls(traffic)} calls")
    return dict(ndcg20=ndcg20, epoch_ms=res.epoch_ms,
                mean_weights=res.mean_weights, launches=launches,
                traffic=traffic)


def checksum(tensors) -> list:
    """Two int64 sums of the tensors' float32 bits (plain, and weighted
    by position), for a bitwise comparison across ranks."""
    import torch

    out = []
    for t in tensors:
        bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out += [bits.sum(), (bits * pos).sum()]
    return torch.stack(out)


@contextlib.contextmanager
def timed_gathers(mesh_lib, device):
    """Record the ms of each ``all_gather_rows`` while open, each from a
    synchronize to a synchronize (the sweeps' row shares)."""
    spent, gather = [], mesh_lib.all_gather_rows

    def timed(mesh, x):
        sync(device)
        t0 = time.perf_counter()
        out = gather(mesh, x)
        sync(device)
        spent.append((time.perf_counter() - t0) * 1000)
        return out

    mesh_lib.all_gather_rows = timed
    try:
        yield spent
    finally:
        mesh_lib.all_gather_rows = gather


def mesh_rank(mesh, root: str, tmp: str, synth, cfg) -> dict:
    """[mesh] (b) and (c) on one rank: each model of MESH_MODELS one
    epoch on ``powerlaw_dataset(*synth, seed=0)`` at ``cfg`` from the
    one-process run's initial tables (``tmp``), held to that run's
    tables; the same epoch twice more from the same tables and generator
    state, once timed (warm) and once with each row share timed; then a
    Server on the SAFER2 model."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from safer2_recommender_tpu_torch import (Dataset, DeviceData,
                                              get_model, interop, probes)
    from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
    from safer2_recommender_tpu_torch.ops import block_chol
    from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh.device
    t0 = time.perf_counter()
    ds = Dataset(*powerlaw_dataset(*synth, seed=0))
    dd = DeviceData.build(ds, device=dev, dim=cfg.dim, mesh=mesh)
    buckets = dd.by_user + dd.by_item
    out = dict(setup_s=time.perf_counter() - t0,
               rows_by_bucket=[b.n_rows for b in buckets],
               live_by_bucket=[int((b.length > 0).sum()) for b in buckets])
    atol = MESH_ATOL * max(1, cfg.dim / 8)
    for name in MESH_MODELS:
        model = get_model(name, cfg, ds.num_users, ds.num_items,
                          device=dev, mesh=mesh)
        with np.load(os.path.join(tmp, f"{name}_init.npz")) as f:
            init = dict(f)
        interop.state_from_jax(init, model, dd, steps=0)
        gen = model.generator.get_state()
        sync(dev)
        block_chol.reset_launches()
        mesh.traffic.reset()
        with probes.recorded_chol_shapes() as shapes:
            t1 = time.perf_counter()
            model.train_epoch(dd)
            sync(dev)
            ms = (time.perf_counter() - t1) * 1000
        traffic = mesh.traffic.snapshot()
        got = model.export_state(dd)
        err = {}
        with np.load(os.path.join(tmp, f"{name}_after.npz")) as f:
            for k in ("user_emb", "item_emb", "user_loss", "dual_weight"):
                want = f[k]
                excess = np.abs(got[k] - want) - (atol + MESH_RTOL
                                                  * np.abs(want))
                err[k] = dict(max_abs=float(np.abs(got[k] - want).max()),
                              max_excess=float(excess.max()))
        launches = dict(block_chol.LAUNCHES)
        s = model.state
        sums = mesh_lib.all_gather_rows(mesh, checksum(
            [s.user_emb, s.item_emb, s.user_loss, s.dual_weight,
             s.xi.reshape(1)])[None]).cpu().numpy()
        again = []
        for timing in (contextlib.nullcontext([]),
                       timed_gathers(mesh_lib, dev)):
            interop.state_from_jax(init, model, dd, steps=0)
            model.generator.set_state(gen)
            with timing as gather_ms:
                sync(dev)
                t1 = time.perf_counter()
                model.train_epoch(dd)
                sync(dev)
            again.append(((time.perf_counter() - t1) * 1000, gather_ms))
        same = bool(torch.equal(model.state.user_emb, s.user_emb)
                    and torch.equal(model.state.item_emb, s.item_emb))
        out[name] = dict(epoch_ms=ms, warm_epoch_ms=again[0][0],
                         timed_epoch_ms=again[1][0],
                         gather_ms=again[1][1], repeat_equal=same,
                         traffic=traffic, shapes=shapes,
                         launches=launches, err=err,
                         mean_dual=model.get_mean_weight(),
                         ranks_equal=bool((sums == sums[0]).all()))
        if name == "safer2":
            out["server"] = mesh_serve(model, ds, dev, block_chol)
        del model, s
    return out


def mesh_serve(model, ds, dev, block_chol) -> dict:
    """[mesh] (c): a Server on the meshed model, over the 256 longest
    histories and 1,024 random users, against its own recommend(); the
    kernel's shapes of both recorded (the rank's)."""
    import numpy as np

    from safer2_recommender_tpu_torch import Server, probes

    rng = np.random.default_rng(SERVE_SEED)
    longest, _ = longest_histories(ds, 256)
    batches = [longest] + user_batches(ds, rng, [1024])
    srv = Server(model, k=10)
    got, ties, ms = [], 0, []
    with probes.recorded_chol_shapes() as shapes:
        for i, batch in enumerate(batches):
            sync(dev)
            t0 = time.perf_counter()
            served = srv.recommend(batch)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1000)
            ties += check_served(f"mesh (c) batch {i}", model, batch,
                                 served, model.recommend(batch, k=10))
            got.append(served)
    return dict(ids=got, near_tie_rows=ties, graphs=srv.num_compiles,
                batch_sizes=list(srv.batch_sizes), ms=ms, shapes=shapes)


def phase_mesh_ranks(block_chol, device, workload, synth=MESH_SYNTH):
    """[mesh] (b) and (c): the one-process epochs of MESH_MODELS on the
    50k workload here, then for each world size of MESH_RANKS that many
    ranks on this one card over gloo (NCCL refuses two ranks on one
    GPU), each model one epoch from the same initial tables, and a Server
    on the meshed SAFER2. ``workload`` is ``(powerlaw_dataset(*synth,
    seed=0) as a Dataset, its DeviceData, Config)``. Returns the readings
    by world size."""
    import numpy as np
    import torch

    from safer2_recommender_tpu_torch import get_model, parallel, probes

    ds, dd, cfg = workload
    single = {}
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        for name in MESH_MODELS:
            model = get_model(name, cfg, ds.num_users, ds.num_items,
                              device=device)
            model.initialize(dd)
            np.savez(os.path.join(tmp, f"{name}_init.npz"),
                     **model.export_state(dd))
            block_chol.reset_launches()
            with probes.recorded_chol_shapes() as shapes:
                sync(device)
                t0 = time.perf_counter()
                model.train_epoch(dd)
                sync(device)
                ms = (time.perf_counter() - t0) * 1000
            np.savez(os.path.join(tmp, f"{name}_after.npz"),
                     **model.export_state(dd))
            single[name] = dict(epoch_ms=ms, shapes=shapes,
                                mean_dual=model.get_mean_weight(),
                                launches=dict(block_chol.LAUNCHES))
            del model
        torch.cuda.empty_cache()
        for n in MESH_RANKS:
            layout = layout_shapes(n, ds, cfg, tmp, device)
            t0 = time.perf_counter()
            ranks = parallel.spawn(mesh_rank, n, device=device,
                                   backend="gloo",
                                   args=(ROOT, tmp, synth, cfg),
                                   timeout_s=600)
            out[n] = check_mesh_ranks(n, ranks, single, layout, ds, cfg,
                                      synth, time.perf_counter() - t0)
    return out


def layout_shapes(n, ds, cfg, tmp, device) -> dict:
    """The kernel's shapes of one epoch of each model of MESH_MODELS in
    this process on the bucket layout of ``n`` ranks (rows padded to a
    multiple of 8 x n, as each rank pads them), from the initial tables
    in ``tmp``: each rank must launch these at 1/n of the systems. The
    padding can make a bucket wide or split a solve batch where the
    default layout's does not, in the JAX package too, which decides from
    the same global shape."""
    import numpy as np
    import torch

    from safer2_recommender_tpu_torch import (DeviceData, get_model, interop,
                                              probes)

    dd = DeviceData.build(ds, device=device, dim=cfg.dim, row_multiple=8 * n)
    out = {}
    for name in MESH_MODELS:
        model = get_model(name, cfg, ds.num_users, ds.num_items,
                          device=device)
        with np.load(os.path.join(tmp, f"{name}_init.npz")) as f:
            interop.state_from_jax(dict(f), model, dd, steps=0)
        with probes.recorded_chol_shapes() as shapes:
            model.train_epoch(dd)
        out[name] = shapes
        del model
    del dd
    torch.cuda.empty_cache()
    return out


def check_mesh_ranks(n, ranks, single, layout, ds, cfg, synth,
                     spawn_s) -> dict:
    """[mesh] (b) and (c) of ``n`` ranks against the one-process epochs
    ``single`` and the one-process launches on their layout ``layout``:
    the checks and the lines."""
    import numpy as np

    from safer2_recommender_tpu_torch.parallel import audit
    from safer2_recommender_tpu_torch.probes import multichip

    where = f"{n} ranks sharing one card (gloo, CUDA tensors)"
    table_bytes = (ds.num_users + ds.num_items) * cfg.dim * 4
    rows = [r["rows_by_bucket"] for r in ranks]
    check(all(x == rows[0] for x in rows),
          f"mesh (b) {n} ranks: the ranks' buckets differ in rows")
    live = np.array([r["live_by_bucket"] for r in ranks])
    padding_only = int((live == 0).any(axis=0).sum())
    out = dict(spawn_s=spawn_s, table_bytes=table_bytes,
               buckets=len(rows[0]), padding_only_buckets=padding_only)
    for name in MESH_MODELS:
        one = single[name]
        rs = [r[name] for r in ranks]
        for i, r in enumerate(rs):
            bad = {k: v for k, v in r["err"].items() if v["max_excess"] > 0}
            check(not bad, f"mesh (b) {n} ranks {name} rank {i}: tables off "
                  f"the one-process epoch beyond rtol {MESH_RTOL:g}, atol "
                  f"{MESH_ATOL:g} x dim/8: {bad}")
            check(abs(r["mean_dual"] - one["mean_dual"]) <= MESH_DUAL_TOL,
                  f"mesh (b) {n} ranks {name} rank {i}: mean dual weight "
                  f"{r['mean_dual']} vs {one['mean_dual']}")
            check(r["ranks_equal"], f"mesh (b) {n} ranks {name}: rank "
                  f"tables differ")
            check(all(m % n == 0 for m, _, _ in layout[name])
                  and r["shapes"] == [(m // n, a, b)
                                      for m, a, b in layout[name]],
                  f"mesh (b) {n} ranks {name} rank {i}: {len(r['shapes'])} "
                  f"launches, not 1/{n} of each of the "
                  f"{len(layout[name])} one process makes on the {n}-rank "
                  f"layout")
            check(r["launches"] and sum(r["launches"].values()) > 0,
                  f"mesh (b) {n} ranks {name} rank {i}: no chol_inverse "
                  f"launch")
            check(r["shapes"] == rs[0]["shapes"],
                  f"mesh (b) {n} ranks {name} rank {i}: other launch shapes "
                  f"than rank 0's")
            check(r["repeat_equal"], f"mesh (b) {n} ranks {name} rank {i}: "
                  f"a repeat of the epoch from the same start differs")
        n_one = sum(sh[0] for sh in one["shapes"])
        n_rank = [sum(sh[0] for sh in r["shapes"]) for r in rs]
        traffic = rs[0]["traffic"]
        ratio = audit.total_bytes(traffic) / table_bytes
        check(list(traffic) == ["all-gather"]
              and traffic["all-gather"][0] == 3
              and ratio <= multichip.EPOCH_BUDGETS[name],
              f"mesh (b) {n} ranks {name}: collectives per epoch {traffic}, "
              f"{ratio:.3f} x the U+V tables")
        out[name] = dict(
            single_epoch_ms=one["epoch_ms"],
            rank_epoch_ms=[r["epoch_ms"] for r in rs],
            rank_warm_epoch_ms=[r["warm_epoch_ms"] for r in rs],
            rank_timed_epoch_ms=[r["timed_epoch_ms"] for r in rs],
            rank_gather_ms=[r["gather_ms"] for r in rs],
            traffic=traffic, collective_calls=audit.total_calls(traffic),
            collective_bytes=audit.total_bytes(traffic),
            bytes_over_tables=ratio,
            launches_single=len(one["shapes"]),
            launches_single_on_layout=len(layout[name]),
            launches_per_rank=[len(r["shapes"]) for r in rs],
            systems_single=n_one, systems_per_rank=n_rank,
            launches_by_r=[r["launches"] for r in rs],
            max_abs_err={k: max(r["err"][k]["max_abs"] for r in rs)
                         for k in rs[0]["err"]},
            mean_dual=[one["mean_dual"]] + [r["mean_dual"] for r in rs],
            shapes=rs[0]["shapes"])
        say("mesh", f"(b) {name}, {synth[0]} x {synth[1]} power-law set, "
            f"dim {cfg.dim}, block {cfg.block_size}, {where}, one "
            f"epoch from the one-process run's tables: epoch ms one process "
            f"{one['epoch_ms']:.1f}, by rank first "
            f"{[round(r['epoch_ms'], 1) for r in rs]}, warm repeat "
            f"{[round(r['warm_epoch_ms'], 1) for r in rs]}, repeat with "
            f"each row share timed {[round(r['timed_epoch_ms'], 1) for r in rs]}"
            f" of which the shares (ms) "
            f"{[[round(t, 1) for t in r['gather_ms']] for r in rs]}; "
            f"collectives per "
            f"epoch {traffic} = {audit.total_bytes(traffic)} B, "
            f"{ratio:.3f} x the U+V tables ({table_bytes} B); chol_inverse "
            f"launches one process {len(one['shapes'])} ({n_one} systems), "
            f"one process on the {n}-rank layout {len(layout[name])} "
            f"({sum(sh[0] for sh in layout[name])} systems), per rank "
            f"{[len(r['shapes']) for r in rs]} ({n_rank} systems), each "
            f"1/{n} of the layout's, shape for shape; "
            f"max abs err vs one process {out[name]['max_abs_err']}; mean "
            f"dual {out[name]['mean_dual']}; ranks bitwise equal")
    served = [r["server"] for r in ranks]
    for i, srv in enumerate(served[1:], 1):
        check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                  for a, b in zip(srv["ids"], served[0]["ids"])),
              f"mesh (c) {n} ranks: rank {i} served other users or ids than "
              f"rank 0")
    out["server"] = dict(
        near_tie_rows=[s["near_tie_rows"] for s in served],
        graphs=served[0]["graphs"], batch_sizes=served[0]["batch_sizes"],
        ms_by_rank=[s["ms"] for s in served],
        users=[int(b[0].size) for b in served[0]["ids"]],
        shapes=sorted({sh for s in served for sh in s["shapes"]}))
    say("mesh", f"(c) Server(k=10) on the {n}-rank SAFER2 model ({where}), "
        f"rungs {served[0]['batch_sizes']} (multiples of 8 x {n}), "
        f"{served[0]['graphs']} graphs per rank, batches of "
        f"{out['server']['users']} users: ids equal recommend()'s on the "
        f"mesh but for near-tie rows {out['server']['near_tie_rows']}, "
        f"equal across ranks; ms per batch by rank "
        f"{[[round(t, 1) for t in s['ms']] for s in served]}")
    say("mesh", f"{where}: spawned, run and joined in {spawn_s:.1f} s "
        f"(data, bucketing and CUDA start-up in each rank; setup "
        f"{[round(r['setup_s'], 1) for r in ranks]} s); {padding_only} of "
        f"{len(rows[0])} buckets leave some rank a block of padding only")
    return out


def phase_mesh_refused():
    """[mesh] (d): ``--mesh 2`` on a one-card machine exits non-zero with
    the JAX CLI's message."""
    import torch

    base = [os.path.join(ML1M, f) for f in
            ("train.csv", "validation_tr.csv", "validation_te.csv")]
    argv = [sys.executable, "-m", "safer2_recommender_tpu_torch.cli",
            "--model_name", "safer2", "--train_data", base[0],
            "--test_train_data", base[1], "--test_test_data", base[2],
            "--mesh", str(torch.cuda.device_count() + 1)]
    res = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    want = (f"--mesh {torch.cuda.device_count() + 1} exceeds the "
            f"{torch.cuda.device_count()} available devices")
    check(res.returncode != 0 and want in res.stderr,
          f"mesh (d): rc {res.returncode}, stderr {res.stderr[-500:]!r}")
    say("mesh", f"(d) {' '.join(argv[2:3] + argv[-2:])}: exit "
        f"{res.returncode}, {want!r}")
    return dict(rc=res.returncode, message=want)


DRYRUN_RANKS = 8


def phase_dryrun8():
    """[dryrun8]: ``dryrun.dryrun_multichip(8, "cuda")``, the counterpart
    of the JAX package's ``dryrun_multichip(8)``: all six models and
    interleaved SAFER2++ on 8 ranks (sharing this card over gloo), a
    finite loss and the SAFER models' mean dual weight within alpha +/-
    0.02 on each rank, every rank in a world of 8."""
    from safer2_recommender_tpu_torch import dryrun

    ranks = dryrun.dryrun_multichip(DRYRUN_RANKS, "cuda")
    check(len(ranks) == DRYRUN_RANKS
          and all(r["world_size"] == DRYRUN_RANKS for r in ranks),
          f"dryrun8: {len(ranks)} ranks")
    check(all(r["runs"] == ranks[0]["runs"] for r in ranks),
          "dryrun8: the ranks' losses or duals differ")
    say("dryrun8", dryrun.describe(ranks))
    return dict(devices=sorted({r["device"] for r in ranks}),
                runs=ranks[0]["runs"])


def phase_multichip():
    """[multichip]: ``probes/multichip.py``: the collective audit at 8
    ranks (SAFER2, SAFER2++, iALS; every rank the same traffic, one
    all-gather per sweep and one for the losses, bytes within the JAX
    package's budgets) and the ML-1M SAFER2 epoch at 1, 2, 4 and 8 ranks
    (finite tables, bitwise equal across ranks, the dual gate). Every
    world above one shares this card: its times check function only."""
    from safer2_recommender_tpu_torch.probes import multichip

    dev = "cuda"
    aud = multichip.audit(dev)
    for line in multichip.describe_audit(aud, dev).splitlines():
        say("multichip", line)
    faults = multichip.audit_faults(aud)
    check(not faults, "multichip audit: " + "; ".join(faults))
    sweep = multichip.sweep(dev)
    for r in sweep:
        say("multichip", multichip.describe_timed(
            f"ML-1M SAFER2 dim {multichip.SWEEP_DIM}", r, dev))
        ranks = r["by_rank"]
        check(all(x["world_size"] == r["ranks"] and x["finite"]
                  for x in ranks)
              and len({x["digest"] for x in ranks}) == 1,
              f"multichip sweep {r['ranks']} ranks: world sizes, nonfinite "
              f"or unequal tables")
        check(abs(ranks[0]["mean_dual"] - ALPHA) <= DUAL_TOL,
              f"multichip sweep {r['ranks']} ranks: mean dual weight "
              f"{ranks[0]['mean_dual']}")
    for r in sweep:
        for x in r["by_rank"]:
            del x["digest"]
    return dict(audit={k: aud[k] for k in ("models", "table_bytes",
                                           "ue_bytes", "input_bytes", "nnz",
                                           "shared")},
                sweep=sweep)


MSD_DIM = 512
# [msd]: each model's timed epochs after its warm-up epoch
MSD_EPOCHS = {"safer2": 2, "ials": 1, "ialspp": 1}
MSD_KEEP = ("safer2", "ialspp")      # evaluated by [eval-msd]
MSD_SERVE_USERS = 1000


def phase_msd(device, wave):
    """[msd]: SAFER2, iALS and iALS++ (block 64) at dim 512 on the full
    synthetic MSD workload (``probes/scale.py``: 571,355 x 41,140,
    ~20.3M tuples) at the MSD config; returns the workload, the readings
    and the SAFER2 and iALS++ models."""
    import torch

    from safer2_recommender_tpu_torch.probes import scale

    wl = scale.build(scale.MSD_USERS, scale.MSD_ITEMS, MSD_DIM, device)
    say("msd", scale.describe_workload(wl))
    out, keep = {}, {}
    for name, epochs in MSD_EPOCHS.items():
        r = scale.train(wl, name, epochs, wave)
        model = r.pop("model")
        say("msd", scale.describe(r))
        launches, paths = r["launches"], r["paths"]
        check(r["finite"], f"msd {name}: nonfinite tables")
        check(len(r["shapes"]) == sum(launches.values()) > 0,
              f"msd {name}: launches {launches} for {len(r['shapes'])} calls")
        check(paths["woodbury"] > 0 and paths["wide"] > 0,
              f"msd {name}: no Woodbury or no wide rows: {paths}")
        if name == "safer2":
            check(abs(r["mean_dual"] - ALPHA) <= DUAL_TOL,
                  f"msd safer2: mean dual weight {r['mean_dual']} left "
                  f"{ALPHA} +/- {DUAL_TOL} after the last epoch")
        if name == "ialspp":
            check(launches[64] > 0 and paths["block"] > 0,
                  f"msd ialspp: no r = 64 block solve: {launches} {paths}")
        if name in MSD_KEEP:
            keep[name] = model
        del model
        torch.cuda.empty_cache()
        out[name] = r
    return wl, out, keep


def phase_eval_msd(wl, models, block_chol):
    """[eval-msd]: the MSD protocol's 50,000 held-out users
    (``probes/eval_scale.py::run_msd``) evaluated by the [msd] SAFER2 and
    iALS++ (whose fold-in runs 8 blockwise sweeps): finite metrics in
    [0, 1], and the first 2,048 held-out users as a fold of their own
    equal, row for row, to the whole fold's but for near-tie swaps."""
    from safer2_recommender_tpu_torch import probes
    from safer2_recommender_tpu_torch.probes import eval_scale

    block_chol.reset_launches()
    with probes.recorded_chol_shapes() as shapes:
        out = eval_scale.run_msd(wl, list(models), trained=models)
    launches = dict(block_chol.LAUNCHES)
    check(len(shapes) == sum(launches.values()) > 0,
          f"eval-msd: launches {launches} for {len(shapes)} calls")
    for name, r in out.items():
        sf = r["subfold"]
        check(r["in_range"], f"eval-msd {name}: metrics not finite in [0, 1]")
        check(sf["differ"] == sf["excused"],
              f"eval-msd {name}: {sf['differ'] - sf['excused']} of "
              f"{sf['rows']} sub-fold rows differ from the whole fold by "
              f"more than a near-tie swap")
    check(out["ialspp"]["fold_in_launches"][64] > 0,
          f"eval-msd ialspp: no r = 64 fold-in solve: "
          f"{out['ialspp']['fold_in_launches']}")
    return dict(models=out, launches=launches, shapes=shapes)


def phase_serve_msd(wl, model, block_chol):
    """[serve-msd]: ``probes/serving_scale.py::serve`` with the [msd]
    SAFER2 on MSD_SERVE_USERS new users against the 41,140-item catalog:
    recommend() exact and approx, and a Server, k = 100."""
    from safer2_recommender_tpu_torch import probes
    from safer2_recommender_tpu_torch.probes import serving_scale

    batch = serving_scale.new_users(MSD_SERVE_USERS, wl.dd.num_items)
    block_chol.reset_launches()
    with probes.recorded_chol_shapes() as shapes:
        r = serving_scale.serve(model, batch)
    launches = dict(block_chol.LAUNCHES)
    say("serve-msd", serving_scale.describe(model.name, r))
    check(serving_scale.ok(r), f"serve-msd: {r}")
    check(sum(launches.values()) > 0, "serve-msd: no chol_inverse launch")
    probes.release_graphs()
    return dict(r, launches=launches, shapes=shapes)


# bench.py's keys (less "regressions" and "backend") plus "device"
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "epoch_ms",
    "safer2pp_dim512_epoch_ms", "ialspp_dim512_epoch_ms",
    "ials_dim512_epoch_ms", "erm_mf_dim512_epoch_ms",
    "cvar_mf_dim512_epoch_ms", "serving_users_per_s_chip",
    "serving_varying_users_per_s_chip", "serving_p50_ms_batch64",
    "serving_compiled_programs", "ml1m_dim32_users_per_s_chip",
    "ml1m_safer2_dim32_ndcg20_10ep", "ml1m_dim32_vs_cpp_1core",
    "ml1m_dim32_epoch_ms", "device", "dim")
ENTRY_TOL = 1e-6     # the card's entry() metrics vs its CPU result


def phase_bench(block_chol):
    """[bench]: ``bench.main`` in this process, its output captured and
    printed: every key of the record present, the numbers finite, the six
    epoch times, NDCG@20 >= NDCG20_MIN, the Server's programs unmoved by
    the varying batches (the count after the batches of 64 is the
    record's), chol_inverse launched."""
    import io
    import math

    from safer2_recommender_tpu_torch import bench, probes

    buf = io.StringIO()
    block_chol.reset_launches()
    with probes.recorded_chol_shapes() as shapes, \
            contextlib.redirect_stdout(buf):
        rc = bench.main([])
    launches = dict(block_chol.LAUNCHES)
    lines = buf.getvalue().splitlines()
    for line in lines:
        say("bench", line)
    check(rc == 0 and lines, f"bench: exit {rc}")
    record = json.loads(lines[-1])
    check(sorted(record) == sorted(BENCH_KEYS),
          f"bench: keys {sorted(record)}, want {sorted(BENCH_KEYS)}")
    numbers = {k: v for k, v in record.items()
               if k not in ("metric", "unit", "device")}
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in numbers.values()), f"bench: {numbers}")
    check(record["device"] == probes.nvidia_smi(),
          f"bench: device {record['device']!r}")
    ndcg = record["ml1m_safer2_dim32_ndcg20_10ep"]
    check(ndcg >= NDCG20_MIN, f"bench: NDCG@20 {ndcg} < {NDCG20_MIN}")
    m = re.search(r"Server programs: (\d+) after warm-up, (\d+) after the "
                  r"varying batches, (\d+) after the batches of 64",
                  lines[-2])
    check(m is not None, "bench: no Server program counts")
    programs = dict(zip(("after_warmup", "after_varying", "at_end"),
                        map(int, m.groups())))
    check(programs["after_varying"] == programs["after_warmup"]
          and programs["at_end"] == record["serving_compiled_programs"],
          f"bench: programs {programs}")
    check(sum(launches.values()) > 0 and shapes,
          f"bench: chol_inverse launches {launches}")
    return dict(record=record, programs=programs, launches=launches,
                shapes=shapes)


def phase_entry(device):
    """[entry]: ``dryrun.entry`` on the card against its own CPU result:
    every user's Recall and NDCG at each k within ENTRY_TOL."""
    from safer2_recommender_tpu_torch import dryrun

    fwd, args = dryrun.entry(device)
    got = [t.cpu() for t in fwd(*args)]
    cfwd, cargs = dryrun.entry("cpu")
    want = cfwd(*cargs)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= ENTRY_TOL, f"entry: card vs CPU metrics differ by {err}")
    say("entry", f"dryrun.entry (256 users x 2,048 items, dim 64; k = "
        f"{list(dryrun.ENTRY_K)}): mean Recall {got[0].mean(0).tolist()}, "
        f"mean NDCG {got[1].mean(0).tolist()}; max |card - CPU| per user "
        f"{err:.3e} (tol {ENTRY_TOL:g})")
    return dict(recall=got[0].mean(0).tolist(), ndcg=got[1].mean(0).tolist(),
                max_abs_err=err)


def phase_classes(block_chol, device):
    """[classes]: SAFER2 on the 50k workload at the MSD config (dim
    512), initialize and two epochs, then two profiled epochs sorted into
    op classes (``probes/epoch_profile.py::profile_classes``): the
    classes sum to the kernels' device time within 0.1%, chol_inverse
    is a class of its own."""
    import torch

    from safer2_recommender_tpu_torch.models import get_model
    from safer2_recommender_tpu_torch.probes import epoch_profile

    ds, dd, cfg = epoch_profile.workload("synth50k", device)
    model = get_model("safer2", cfg, ds.num_users, ds.num_items,
                      device=device)
    block_chol.reset_launches()
    model.initialize(dd)
    model.train_epochs(dd, 2)
    t = epoch_profile.profile_classes(model, dd)
    launches = dict(block_chol.LAUNCHES)
    for line in epoch_profile.describe_classes(t):
        say("classes", line)
    check(abs(t["gap"]) <= 1e-3, f"classes: the classes sum to "
          f"{t['total_ms']} ms, "
          f"the kernels to {t['kernel_ms']} ms")
    check(t["classes"]["chol_inverse"]["launches"] > 0
          and sum(launches.values()) > 0,
          f"classes: no chol_inverse launch: {launches}")
    del model, dd
    torch.cuda.empty_cache()
    return dict(t, launches=launches)


def phase_roofline(device):
    """[roofline]: ``probes/roofline.py``: attained rates beside the
    published peaks."""
    import math

    from safer2_recommender_tpu_torch.probes import roofline

    rows = roofline.run(device)
    for row in rows:
        say("roofline", roofline.describe(row))
    check(all(math.isfinite(r["rate"]) and r["rate"] > 0 for r in rows),
          f"roofline: {rows}")
    return rows


def phase_ops(device) -> None:
    """[ops]: the four op-family probes (probes/quantile.py, gather.py,
    eigh.py, seqdot.py) at the JAX scripts' full sizes on the card; each
    reading printed beside its bound, and every check of the docstring's
    phase 30 held."""
    import math

    from safer2_recommender_tpu_torch.probes import (eigh, gather,
                                                     quantile, seqdot)

    q = quantile.run(device)
    for row in q["rows"]:
        say("ops", "quantile " + quantile.describe(q, row))
    xis = {row["name"]: row["xi"] for row in q["rows"]}
    check(set(xis.values()) == {q["host_xi"]},
          f"ops: xi {xis} against np.partition's {q['host_xi']}")

    rows = gather.run(device)
    for row in rows:
        say("ops", "gather " + gather.describe(row))
    bad = [row["name"] for row in rows
           if not row.get("equal", True) or not row.get("host_equal", True)]
    check(not bad, f"ops: gathers or write-backs that differ: {bad}")

    res = eigh.run(device)
    for line in eigh.describe(res):
        say("ops", "eigh " + line)
    bad = [row["name"] for row in eigh.eigh_rows(res)
           if not eigh.eigh_ok(row)]
    bad += [f"route [{row['batch']}, {row['d']}]" for row in res["route"]
            if not eigh.route_ok(row)]
    check(not bad, f"ops: eigh rows not finite, or the port's route "
          f"(woodbury.sym_eigh) or the float64 route reconstructing over "
          f"{eigh.RECON_TOL}, or the port's orthogonal only over "
          f"{eigh.ORTH_TOL}: {bad}")
    shared = res["shared"]
    check(shared["newton_schulz"]["finite"]
          and all(map(math.isfinite, shared["drift"].values()))
          and math.isfinite(shared["refresh"]["error"]),
          f"ops: eigh readings not finite: {shared}")

    rows = seqdot.run(device)
    for row in rows:
        say("ops", "seqdot " + seqdot.describe(row))
    bad = [(row["d"], row["name"], row["precision"]) for row in rows
           if not max(row["errors"]) <= row["tol"]]
    check(not bad, f"ops: dependent products off the float64 chain: {bad}")


def phase_oracle(block_chol, device) -> dict:
    """[oracle]: every model's epoch on the card against the float64
    oracles (probes/oracle.py) at dims 8, 128 and 512, each held to
    rtol 2e-4, atol 2e-5 x max(1, dim / 8) (oracle.row_ok), at 512 to
    oracle.SHARP_ABS_512 too, with the raw float32 eigh's run its
    control, every solve route of the model's epoch taking rows at 512;
    SAFER2, iALS and iALS++ at 256 held at the default eig_refresh_tol,
    and at the JAX package's 0.08 the warm refresh's second epochs
    printed beside them as readings."""
    from safer2_recommender_tpu_torch.probes import oracle

    block_chol.reset_launches()
    rows = oracle.run(device)
    launches = dict(block_chol.LAUNCHES)
    for row in rows:
        say("oracle", oracle.describe(row))
    bad = [f"{row['key']} dim {row['dim']}" for row in rows
           if not oracle.row_ok(row)]
    check(not bad, f"oracle: epochs off the float64 oracle or past the "
          f"dim-512 limit, a raw float32 control within it, a refresh "
          f"branch not the expected one, or a solve route not taken: {bad}")
    check(sum(launches.values()) > 0, f"oracle: no chol_inverse launch: "
          f"{launches}")
    return dict(launches=launches, rows=rows)


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
    from safer2_recommender_tpu_torch import probes

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(probes.nvidia_smi(), flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, float32_matmul_precision="
        f"{torch.get_float32_matmul_precision()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_root:
        run_phases(device, ckpt_root)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(device, ckpt_root: str) -> None:
    """Phases 2-33; the kernel JSON line at the end. The CLI runs of
    phases 6, 11, 12 and 13 save their checkpoints under
    ``ckpt_root``."""
    import torch

    from safer2_recommender_tpu_torch import cli, probes
    from safer2_recommender_tpu_torch.ops import (bdot, block_chol,
                                                  grad_gather, woodbury)
    from safer2_recommender_tpu_torch.probes import bdot as bdot_probe
    from safer2_recommender_tpu_torch.probes import chol_inverse as chol_probe
    from safer2_recommender_tpu_torch.probes import grad_gather as gg_probe

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as ex:
        builds = [ex.submit(block_chol.build_kernel),
                  ex.submit(bdot.build_kernel),
                  ex.submit(grad_gather.build_kernel)]
        ptxas = ex.submit(chol_probe.ptxas_report)
        bdot_ptxas = ex.submit(bdot_probe.ptxas_report)
        gg_ptxas = ex.submit(gg_probe.ptxas_report)
        for f in builds:
            f.result()
        ptxas, bdot_ptxas = ptxas.result(), bdot_ptxas.result()
        gg_ptxas = gg_ptxas.result()
    say("build", f"chol_inverse.cu, bdot.cu and grad_gather.cu built (in "
        f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")
    say("build", "nvcc -Xptxas -v of chol_inverse.cu: " + " | ".join(ptxas))
    say("build", "nvcc -Xptxas -v of bdot.cu: " + " | ".join(bdot_ptxas))
    say("build", "nvcc -Xptxas -v of grad_gather.cu: " + " | ".join(gg_ptxas))

    by_r = phase_kernel(chol_probe, device)
    bdot_err = phase_bdot(bdot, device)
    phase_solve(block_chol, chol_probe, device)
    t0 = time.perf_counter()
    gg_rows = phase_grad_gather(device)
    gg_probe_launches = grad_gather.LAUNCHES
    say("grad_gather", f"phase {time.perf_counter() - t0:.1f} s")

    block_chol.reset_launches()
    with probes.recorded_chol_shapes() as shapes:
        res = train(cli, 32, 10, ckpt=os.path.join(ckpt_root, "safer2"))
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
    res512 = d512.pop("res")
    ndcg512 = float(res512.metrics.mean_ndcg()[2])
    shapes512 = d512.pop("shapes")
    bf16_ml1m, bf16_model = phase_bf16_ml1m(
        cli, block_chol, woodbury,
        run_facts(res512, d512["launches"], shapes512, d512["paths"],
                  d512["peak_bytes"]),
        os.path.join(ckpt_root, "safer2_bf16"))
    f32_model512 = res512.model
    del res512

    from safer2_recommender_tpu_torch.probes import epoch_profile

    t0 = time.perf_counter()
    workload = epoch_profile.workload("synth50k", device)
    synth = phase_synth(block_chol, woodbury, device, workload,
                        time.perf_counter() - t0)
    t0 = time.perf_counter()
    refresh_res = phase_refresh(block_chol, device, workload)
    say("refresh", f"phase {time.perf_counter() - t0:.1f} s")

    models, trained = phase_models(cli, block_chol, ckpt_root)
    inter, inter_trained = phase_interleaved(cli, block_chol, woodbury,
                                             ckpt_root)
    cg, cg_trained = phase_cg(cli, block_chol, ckpt_root, res.epoch_ms)
    trained = dict(safer2=res.model, **trained, **inter_trained,
                   **cg_trained)
    del inter_trained, cg_trained
    server = phase_server(
        trained, {n: os.path.join(ckpt_root, n) for n in trained},
        block_chol, device)
    del trained

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = {r: sms * block_chol.resident_systems(r)
            for r in block_chol.KERNEL_SIZES}
    synth_models = phase_synth_models(block_chol, woodbury, device, workload,
                                      wave)
    bf16_synth, bf16_models = phase_bf16_synth(
        block_chol, woodbury, device, workload,
        {"safer2": synth["model"],
         "safer2pp": synth_models["safer2pp"]["model"]},
        {"safer2": synth["epoch_ms"],
         "safer2pp": synth_models["safer2pp"]["epoch_ms"]})
    bf16_gram = phase_bf16_gram(bf16_models["safer2"], workload[1], device)
    del bf16_models
    batches, b64 = server_batches()
    fresh, epoch = restore_fresh(bf16_model,
                                 os.path.join(ckpt_root, "safer2_bf16"))
    bf16_server = serve_model("server bf16", bf16_model, fresh, batches, b64,
                              block_chol, device)
    bf16_server["restored_epoch"] = epoch
    say("bf16", f"ML-1M SAFER2 dim 512 bf16, restored at epoch {epoch}: "
        + describe_served(bf16_server))
    bf16_ml1m["profile"] = profile_pair(
        "ML-1M safer2 dim 512", {"f32": f32_model512, "bf16": bf16_model},
        epoch_profile.workload("ml1m", device)[1])
    del fresh, bf16_model, f32_model512, batches, b64
    probes.release_graphs()
    bf16_profile = phase_profile_dir(cli, block_chol, ckpt_root)
    server50k = phase_server50k(
        {"safer2": synth.pop("model"),
         "safer2pp": synth_models["safer2pp"].pop("model")},
        workload[0], block_chol, device)
    inter50k = phase_interleaved50k(block_chol, woodbury, device, workload,
                                    wave)
    mesh = dict(cli=phase_mesh_cli(cli, block_chol, ndcg512, shapes512),
                ranks=phase_mesh_ranks(block_chol, device, workload),
                refused=phase_mesh_refused())
    del workload
    probes.release_graphs()
    t0 = time.perf_counter()
    dryrun8 = phase_dryrun8()
    say("dryrun8", f"phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multichip = phase_multichip()
    say("multichip", f"phase {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    msd_wl, msd, msd_models = phase_msd(device, wave)
    say("msd", f"phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_msd = phase_eval_msd(msd_wl, msd_models, block_chol)
    say("eval-msd", f"phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve_msd = phase_serve_msd(msd_wl, msd_models["safer2"], block_chol)
    say("serve-msd", f"phase {time.perf_counter() - t0:.1f} s")
    del msd_wl, msd_models
    probes.release_graphs()

    t0 = time.perf_counter()
    bench = phase_bench(block_chol)
    say("bench", f"phase {time.perf_counter() - t0:.1f} s")
    probes.release_graphs()
    entry = phase_entry(device)
    t0 = time.perf_counter()
    classes = phase_classes(block_chol, device)
    say("classes", f"phase {time.perf_counter() - t0:.1f} s")
    roofline = phase_roofline(device)
    t0 = time.perf_counter()
    phase_ops(device)
    say("ops", f"phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oracle_res = phase_oracle(block_chol, device)
    say("oracle", f"phase {time.perf_counter() - t0:.1f} s")

    bdot.reset_launches()
    probe = bdot_probe.run(device=device)
    probe_launches = bdot.LAUNCHES
    check(probe_launches > 0, "probe: the bdot kernel was never launched")

    shapes50k = synth.pop("shapes")
    shapes_pp = synth_models["safer2pp"]["shapes"]
    shapes_inter = inter["safer2pp_interleaved"].pop("shapes")
    shapes_inter_ialspp = inter["ialspp_interleaved"].pop("shapes")
    shapes_inter50k = inter50k.pop("shapes")
    hist = {"ml1m_dim512": probes.launch_histogram(shapes512, wave),
            "synth50k_dim512": probes.launch_histogram(shapes50k, wave),
            "ml1m_interleaved_safer2pp_dim512": probes.launch_histogram(
                shapes_inter, wave),
            "ml1m_interleaved_ialspp_dim32": probes.launch_histogram(
                shapes_inter_ialspp, wave),
            "synth50k_interleaved_safer2pp": inter50k.pop(
                "launch_histogram")}
    for name, m in synth_models.items():
        del m["shapes"]
        hist[f"synth50k_{name}"] = m.pop("launch_histogram")
    shapes_msd = [sh for m in msd.values() for sh in m.pop("shapes")]
    for name, m in msd.items():
        hist[f"msd_{name}"] = m.pop("launch_histogram")
    shapes_eval_msd = eval_msd.pop("shapes")
    hist["eval_msd"] = probes.launch_histogram(shapes_eval_msd, wave)
    say("kernel", f"one wave (SMs x systems resident on one) by r: {wave}; "
        f"launches by r and N, ML-1M dim 512 (5 epochs + eval; the serve "
        f"batch excluded), synth50k (SAFER2, 2 epochs), each model of "
        f"synth50k-models (initialize + 3 epochs + a fold-in for the ++ "
        f"models), the interleaved ML-1M runs ({INTERLEAVED_EPOCHS} and 10 "
        f"epochs + eval), interleaved50k (initialize + 3 epochs), each "
        f"model of msd (initialize + warm-up + timed epochs) and eval-msd "
        f"(both models): {json.dumps(hist)}")
    size = lambda sh: sh[0] * sh[1] * sh[2]
    served = {"server_ml1m": [sh for r in server.values()
                              for sh in r.pop("shapes")]}
    for name, r in server50k.items():
        served[f"server50k_{name}"] = r.pop("shapes")
    served["server_ml1m_dim512_bf16"] = bf16_server.pop("shapes")
    # each rank's shapes of [mesh] (b) (about 1/n of the one-process N)
    # and of the meshed Server (c): rank 0's, equal to every rank's by
    # (b)'s check
    for n in MESH_RANKS:
        for name in MESH_MODELS:
            served[f"mesh{n}_rank_synth50k_{name}"] = mesh["ranks"][n][
                name].pop("shapes")
        served[f"mesh{n}_server"] = mesh["ranks"][n]["server"].pop("shapes")
    served["serve_msd"] = serve_msd.pop("shapes")
    shapes_bench = bench.pop("shapes")
    main_shapes = {
        "largest_ml1m_dim512": max(shapes512, key=size),
        "most_frequent_ml1m_dim512": most_frequent(shapes512),
        "largest_synth50k": max(shapes50k, key=size),
        "most_frequent_synth50k": most_frequent(shapes50k),
        "largest_synth50k_safer2pp": max(shapes_pp, key=size),
        "most_frequent_synth50k_safer2pp": most_frequent(shapes_pp),
        "largest_ml1m_interleaved_dim512": max(shapes_inter, key=size),
        "most_frequent_ml1m_interleaved_dim512": most_frequent(shapes_inter),
        "largest_ml1m_interleaved_ialspp_dim32": max(shapes_inter_ialspp,
                                                     key=size),
        "most_frequent_ml1m_interleaved_ialspp_dim32": most_frequent(
            shapes_inter_ialspp),
        "largest_synth50k_interleaved": max(shapes_inter50k, key=size),
        "most_frequent_synth50k_interleaved": most_frequent(
            shapes_inter50k),
        "largest_msd": max(shapes_msd, key=size),
        "most_frequent_msd": most_frequent(shapes_msd),
        "largest_eval_msd": max(shapes_eval_msd, key=size),
        "most_frequent_eval_msd": most_frequent(shapes_eval_msd),
        "largest_bench": max(shapes_bench, key=size),
        "most_frequent_bench": most_frequent(shapes_bench)}
    for key, sh in served.items():
        main_shapes[f"largest_{key}"] = max(sh, key=size)
        main_shapes[f"most_frequent_{key}"] = most_frequent(sh)
    main_t = {}
    for key, shape in main_shapes.items():
        main_t[key] = time_at(chol_probe, device, shape)
        say("kernel", f"{key} {chol_probe.describe(main_t[key])}; max rel "
            f"err {main_t[key]['max_rel_err']:.3e} (tol {REL_TOL:g})")
    # every other shape the served and meshed paths gave the kernel,
    # compared only
    rest = sorted({sh for v in served.values() for sh in v if sh[0] > 0}
                  - set(main_shapes.values()))
    served_err = 0.0
    for shape in rest:
        served_err = max(served_err,
                         check_at(chol_probe, device, shape)[2]["max_abs_err"])
    say("kernel", f"the kernel against its plain version at the other "
        f"{len(rest)} shapes of the served and meshed paths "
        f"{[list(sh) for sh in rest]}"
        f": max abs err {served_err:.3e}, each system's rel err within "
        f"{REL_TOL:g}")
    head = main_t["largest_ml1m_dim512"]
    gg_head = next(r for r in gg_rows
                   if r["side"] == "item" and r["label"] == "largest")
    probe_rows = {(row["h"], row["precision"]): row for row in probe["bdot"]}
    bdot_head = probe_rows[128, "highest"]
    print(json.dumps({"kernels": [{
        "name": "chol_inverse",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/chol_inverse.cu",
        "replaces": ("safer2_recommender_tpu/ops/block_chol.py:120 "
                     "(_leaf_lane/_leaf_kernel); "
                     "safer2_recommender_tpu/ops/block_chol.py:163 "
                     "(_lane_matmul/_lane_matmul_kernel)"),
        "launches": (sum(d512["launches"].values())
                     + sum(d512["jax_tol"]["launches"].values())
                     + sum(refresh_res["launches"].values())
                     + sum(sum(m["launches"].values())
                           for m in models.values())
                     + sum(m["total_launches"]
                           for m in synth_models.values())
                     + sum(sum(m["launches"].values())
                           for m in inter.values())
                     + sum(inter50k["launches"].values())
                     + sum(sum(r["launches"].values())
                           for r in list(server.values())
                           + list(server50k.values()) + [bf16_server])
                     + sum(bf16_ml1m["launches"].values())
                     + sum(sum(r["launches"].values())
                           for k, r in bf16_synth.items() if k != "profile")
                     + bf16_profile["launches"]
                     + sum(mesh["cli"]["launches"].values())
                     + sum(sum(by_r.values()) for n in MESH_RANKS
                           for name in MESH_MODELS
                           for by_r in mesh["ranks"][n][name]["launches_by_r"])
                     + sum(sum(m["launches"].values()) for m in msd.values())
                     + sum(eval_msd["launches"].values())
                     + sum(serve_msd["launches"].values())
                     + sum(bench["launches"].values())
                     + sum(classes["launches"].values())
                     + sum(oracle_res["launches"].values())),
        "max_abs_err": max([v["max_abs_err"] for v in by_r.values()]
                           + [v["max_abs_err"] for v in main_t.values()]
                           + [served_err]),
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
            "ml1m_dim512_jax_tol": d512["jax_tol"]["launches"],
            "refresh": refresh_res["launches"],
            "serve_dim512": d512["serve_launches"],
            "synth50k_dim512": synth["launches"],
            "ml1m_dim32_models": {n: m["launches"]
                                  for n, m in models.items()},
            "synth50k_models": {n: m["launches"]
                                for n, m in synth_models.items()},
            "synth50k_models_fold_in": {
                n: m["fold_in"]["launches"]
                for n, m in synth_models.items() if m["fold_in"]},
            "ml1m_interleaved": {
                n: dict(per_epoch=m["launches_per_epoch"],
                        whole_run=m["launches"]) for n, m in inter.items()},
            "synth50k_interleaved": dict(
                per_epoch=inter50k["launches_per_epoch"],
                whole_run=inter50k["launches"]),
            "ml1m_cg": {n: m["launches"] for n, m in cg.items()},
            "server_ml1m": {
                n: dict(launches=r["launches"], per_capture=r["per_capture"],
                        graphs=r["graphs"], replays=r["replays"])
                for n, r in server.items()},
            "server50k": {
                n: dict(launches=r["launches"], per_capture=r["per_capture"],
                        graphs=r["graphs"], replays=r["replays"])
                for n, r in server50k.items()},
            "bf16": {
                "ml1m_dim512": bf16_ml1m["launches"],
                "synth50k": {n: r["launches"] for n, r in bf16_synth.items()
                             if n != "profile"},
                "server_ml1m_dim512": dict(
                    launches=bf16_server["launches"],
                    per_capture=bf16_server["per_capture"],
                    graphs=bf16_server["graphs"],
                    replays=bf16_server["replays"]),
                "profile_dir_run": bf16_profile["launches"]},
            "mesh": {
                "cli_distributed_world1": mesh["cli"]["launches"],
                "ranks_synth50k": {
                    n: {name: mesh["ranks"][n][name]["launches_by_r"]
                        for name in MESH_MODELS} for n in MESH_RANKS}},
            "msd": {n: m["launches"] for n, m in msd.items()},
            "eval_msd": eval_msd["launches"],
            "serve_msd": serve_msd["launches"],
            "bench": bench["launches"],
            "classes": classes["launches"],
            "oracle": oracle_res["launches"]},
        "by_r": {str(r): v for r, v in by_r.items()},
        "serve_users_per_s": users_per_s,
        "ml1m_dim32_epoch_ms": res.epoch_ms,
        "ml1m_dim512_ndcg20": ndcg512,
        "ml1m_dim512": d512,
        "synth50k": synth,
        "refresh": refresh_res["rows"],
        "ml1m_dim32_models": models,
        "synth50k_models": synth_models,
        "ml1m_interleaved": inter,
        "synth50k_interleaved": inter50k,
        "ml1m_cg": cg,
        "server_ml1m": server,
        "server50k": server50k,
        "bf16": dict(ml1m_dim512=bf16_ml1m, synth50k=bf16_synth,
                     gram=bf16_gram, server_ml1m_dim512=bf16_server,
                     profile_dir=bf16_profile),
        "mesh": mesh,
        "dryrun8": dryrun8,
        "multichip": multichip,
        "msd": msd,
        "eval_msd": eval_msd,
        "serve_msd": serve_msd,
        "bench": bench,
        "entry": entry,
        "classes": classes,
        "roofline": roofline,
        "oracle": oracle_res,
    }, {
        "name": "bdot",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/bdot.cu",
        "replaces": "scripts/probe_bdot.py:27 (pallas_bdot)",
        "launches": probe_launches,
        "max_abs_err": max(e["max_abs_err"] for v in bdot_err.values()
                           for e in v.values()),
        "ms": bdot_head["ms"],
        "plain_ms": bdot_head["plain_ms"],
        "bound_ms": bdot_head["bound_ms"],
        "bound_by": bdot_head["bound_by"],
        "library_ms": bdot_head["library_ms"],
        "shape": [4096, 128, 128],
        "precision": "highest",
        "by_precision": {
            str(h): {p: dict(bdot_err[h][p], **probe_rows[h, p])
                     for p in bdot.PASSES}
            for h in bdot.SIZES},
        "ptxas": bdot_ptxas,
        "solver_products": probe["solver"],
    }, {
        "name": "grad_gather",
        "route": "cuda",
        "source": "safer2_recommender_tpu_torch/csrc/grad_gather.cu",
        "replaces": ("none: the JAX package leaves CVaR-MF's gradient step "
                     "to XLA (safer2_recommender_tpu/models/cvar_mf.py:36 "
                     "_grad_step_u, :53 _grad_step_v)"),
        "launches": (gg_probe_launches
                     + models["cvar_mf"]["grad_gather_launches"]
                     + synth_models["cvar_mf"]["grad_gather_launches"]),
        "launches_by_path": {
            "probe_msd_buckets": gg_probe_launches,
            "ml1m_dim32_cvar_mf": models["cvar_mf"]["grad_gather_launches"],
            "synth50k_cvar_mf": synth_models["cvar_mf"][
                "grad_gather_launches"],
            "other_models": {
                path: {n: m["grad_gather_launches"] for n, m in ms.items()
                       if n != "cvar_mf"}
                for path, ms in (("ml1m_dim32", models),
                                 ("synth50k", synth_models))}},
        "max_rel_err": max(r["max_rel_err"] for r in gg_rows),
        "ms": gg_head["kernel_ms"],
        "plain_ms": gg_head["plain_ms"],
        "bound_ms": gg_head["gathered_ms"],
        "bound_by": "gathered rows from device memory at 3.35 TB/s",
        "compulsory_bound_ms": gg_head["compulsory_ms"],
        "shape": [gg_head["rows"], gg_head["width"], 512],
        "main_path_shapes": gg_rows,
        "ptxas": gg_ptxas,
    }]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
