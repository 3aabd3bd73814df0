"""Where a dim-512 SAFER2 epoch spends its time on the GPU.

    python -m safer2_recommender_tpu_torch.probes.epoch_profile

For each of two workloads, ML-1M (the bundled ``tests/ml-1m`` split at
the README config) and the 50k x 40k power-law set at the MSD config of
``bench.py`` (``synth50k``), both at dim 512, seeded:

1. two warm-up epochs;
2. the phases of one epoch, each timed from a synchronize to a
   synchronize on the host clock, three times from the same state
   (the state is not advanced), with the median printed: the loss pass,
   the xi line search, the z-step, the U sweep's eigenbasis alone, the
   U sweep with its eigenbasis, the V sweep with its eigenbasis, the
   Gramian;
3. ``torch.profiler`` over two more epochs: their wall time, the device
   busy time (the union of the device activity intervals, so
   overlapping streams are not counted twice) and its share of the
   wall time, and the device operations that took the most time.

The profiler inflates the wall time; the idle share it gives is an
upper bound on what ``chip_smoke.py``'s unprofiled epochs see. A
machine without CUDA is an error.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, Sequence, Tuple

import torch

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import common, get_model
from safer2_recommender_tpu_torch.ops import smoothing, woodbury

DIM = 512
ML1M_TRAIN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests", "ml-1m", "train.csv")
# CUPTI's own bookkeeping, reported as device activity but no work
_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")


def ml1m_config() -> Config:
    """The README's ML-1M SAFER2 config at dim 512."""
    return Config(dim=DIM, uobs_weight=0.004, l2_reg=0.004, alpha=0.3,
                  bandwidth=0.15, seed=0)


def msd_config() -> Config:
    """The MSD config of ``bench.py:114-117``, the JAX package's north
    star (dim 512)."""
    return Config(dim=DIM, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                  bandwidth=0.1, use_snr=True, sampling_ratio=0.1, seed=0)


def workload(name: str, device) -> Tuple[Dataset, DeviceData, Config]:
    """``"ml1m"`` or ``"synth50k"``: the training set, its device data
    and the config, at dim 512."""
    if name == "ml1m":
        ds, cfg = Dataset.from_csv(ML1M_TRAIN), ml1m_config()
    elif name == "synth50k":
        ds = Dataset(*powerlaw_dataset(50_000, 40_000, seed=0))
        cfg = msd_config()
    else:
        raise ValueError(f"unknown workload {name!r}")
    return ds, DeviceData.build(ds, device=device, dim=cfg.dim), cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_ms(model, dd: DeviceData) -> Dict[str, float]:
    """One epoch's phases (``SAFER2._epoch`` with one pd iteration), each
    timed from a synchronize to a synchronize; leaves the model's state
    as it was."""
    cfg, s, device = model.cfg, model.state, dd.device
    ms: Dict[str, float] = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    loss, pre = timed("loss", lambda: common.gather_and_losses(
        s.item_emb, dd.by_user, s.user_emb, s.item_gramian, dd.num_users,
        cfg.uobs_weight, halve=True))
    xi = timed("xi", lambda: model._xi(loss, s, s.xi))
    dual = timed("z", lambda: torch.where(
        dd.user_hist_size > 0,
        smoothing.dual_weight(loss, xi, cfg.bandwidth, cfg.use_epanechnikov),
        s.dual_weight))
    timed("eigh_u", lambda: woodbury.maybe_eigh(
        s.item_gramian, cfg.dim, use_cg=cfg.use_cg, q_prev=s.eig_qu,
        refresh_tol=cfg.eig_refresh_tol))
    u, _ = timed("U_incl_eigh", lambda: model._step_u(
        s.user_emb, s.item_emb, s.item_gramian, dd.by_user, dual,
        pre_list=pre, q_prev=s.eig_qu))
    del pre
    v, _ = timed("V_incl_eigh", lambda: model._step_v(
        s.item_emb, u, dd, dual, q_prev=s.eig_qv))
    timed("gram", lambda: v.T @ v)
    return ms


def busy_ms(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def profile_epochs(model, dd: DeviceData):
    """Profile two epochs: (wall ms, device busy ms, the twelve device
    operations that took the most time, and every launch of the port's
    inverse-Cholesky kernel, each as (ms, count, name))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dd.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epochs(dd, 2)
        _sync(dd.device)
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or e.name in _OVERHEAD):
            continue
        spans.append((e.time_range.start / 1e3, e.time_range.end / 1e3))
        acc = by_name[e.name]
        acc[0] += (e.time_range.end - e.time_range.start) / 1e3
        acc[1] += 1
    ranked = sorted(((t, n, name) for name, (t, n) in by_name.items()),
                    reverse=True)
    chol = [row for row in ranked if "chol_inverse" in row[2]]
    return wall, busy_ms(spans), ranked[:12], chol


def run() -> Dict[str, dict]:
    """Measure and print both workloads on the current CUDA device;
    returns the numbers by workload name."""
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name in ("ml1m", "synth50k"):
        ds, dd, cfg = workload(name, device)
        model = get_model("safer2", cfg, ds.num_users, ds.num_items,
                          device=device)
        model.initialize(dd)
        model.train_epochs(dd, 2)
        runs = [phase_ms(model, dd) for _ in range(3)]
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"[profile {name}] phase ms, median of 3 from one state: "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items()),
              flush=True)
        wall, busy, ranked, chol = profile_epochs(model, dd)
        print(f"[profile {name}] 2 profiled epochs: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%), "
              f"idle {100 * (1 - busy / wall):.1f}%", flush=True)
        for ms, count, op in ranked:
            print(f"[profile {name}]   {ms:9.3f} ms x {count:5d}  "
                  f"{op[:110]}", flush=True)
        for ms, count, op in chol:
            print(f"[profile {name}] inverse-Cholesky kernel {ms:.3f} ms x "
                  f"{count} launches  {op[:110]}", flush=True)
        out[name] = dict(phase_ms=med, wall_ms=wall, busy_ms=busy,
                         top=[dict(ms=ms, count=c, name=op)
                              for ms, c, op in ranked],
                         chol_inverse=[dict(ms=ms, count=c, name=op)
                                       for ms, c, op in chol])
        del model, dd
        torch.cuda.empty_cache()
    return out


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
