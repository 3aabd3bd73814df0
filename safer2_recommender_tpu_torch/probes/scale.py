"""Training at MSD scale: the counterpart of the JAX package's
``scripts/bench_scale.py``.

    python -m safer2_recommender_tpu_torch.probes.scale \\
        [num_users] [num_items] [dim] [model] [--epochs N] [--device D]

Defaults 200,000 users, 40,000 items, dim 512, ``safer2``, 2 timed
epochs, the card. The Million Song Dataset, the reference's largest
benchmark, cannot be downloaded without network access; the workload is
``data/synth.py::powerlaw_dataset(num_users, num_items, seed=0)``, of
its shape (log-normal histories, zipf-0.8 items). ``571355 41140`` is
its full size: 571,355 users, 41,140 items, about 20.3M tuples. The
model runs at the MSD config of ``probes/epoch_profile.py::msd_config``
at ``dim`` (block 64 for the ++ models, or ``dim`` where it is smaller).

It prints:

* the tuple count and the host seconds of the Dataset (the draw),
  ``DeviceData.build`` (sort, bucketing, the copies to the device) and
  the model's first note of the solver order (``_note_perms``), so that
  a slow set-up is not counted in an epoch;
* per side, the buckets, the wide (column-chunked) ones, the solve
  groups of ``models/common.py::_solve_groups`` (the buckets cut under
  its 2 GiB budget) and the widest bucket;
* ``initialize`` and each epoch in ms (one warm-up, then ``--epochs``
  timed: a host clock after a synchronize) and users/s;
* rows by solve path (``ops/woodbury.py::SOLVE_PATHS``);
* ``chol_inverse`` launches by r and, on the card, how many of them
  hold fewer systems than one wave;
* the peak device memory beside the card's total (not measured on the
  CPU).

Every reading comes from the run that prints it; on the CPU (``--device
cpu``, a tiny size) it checks the control flow only: no launch is
counted there and no time is the card's.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import (MODEL_REGISTRY, common,
                                                 get_model)
from safer2_recommender_tpu_torch.ops import assemble, block_chol, woodbury
from safer2_recommender_tpu_torch.probes import epoch_profile
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       resolve_device)

NUM_USERS, NUM_ITEMS, DIM, MODEL = 200_000, 40_000, 512, "safer2"
# the full synthetic MSD workload (README.md "MSD-scale" of the JAX package)
MSD_USERS, MSD_ITEMS = 571_355, 41_140
BLOCK = 64
EPOCHS = 2


@dataclasses.dataclass
class Workload:
    """A training set on a device with its config and set-up seconds."""

    ds: Dataset
    dd: DeviceData
    cfg: Config
    dataset_s: float
    build_s: float


def build(num_users: int = NUM_USERS, num_items: int = NUM_ITEMS,
          dim: int = DIM, device=DEFAULT_DEVICE) -> Workload:
    """The power-law workload (seed 0) bucketed on ``device`` at the MSD
    config; the tables are sized ``num_users`` x ``num_items`` even where
    the draw missed the last ids."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    ds = Dataset(*powerlaw_dataset(num_users, num_items, seed=0))
    t1 = time.perf_counter()
    dd = DeviceData.build(ds, device=device, num_users=num_users,
                          num_items=num_items, dim=dim)
    probes.sync(device)
    t2 = time.perf_counter()
    cfg = epoch_profile.msd_config().replace(dim=dim,
                                             block_size=min(BLOCK, dim))
    return Workload(ds, dd, cfg, t1 - t0, t2 - t1)


def layout(wl: Workload) -> Dict[str, dict]:
    """Per side: buckets, the wide (column-chunked) ones, the solve
    groups that ``models/common.py::_solve_groups`` cuts them into under
    its memory budget, and the widest bucket. Which rows each path
    solves is counted as they run (``woodbury.SOLVE_PATHS``)."""
    dim, out = wl.cfg.dim, {}
    for side, buckets in (("user", wl.dd.by_user), ("item", wl.dd.by_item)):
        out[side] = dict(
            buckets=len(buckets),
            wide=sum(assemble.is_wide(b, dim) for b in buckets),
            solve_groups=len(common._solve_groups(buckets, dim)),
            widest=max((b.width for b in buckets), default=0))
    return out


def train(wl: Workload, name: str, epochs: int = EPOCHS,
          wave: Optional[Dict[int, int]] = None) -> dict:
    """``name`` on the workload: the solver-order note, ``initialize``,
    one warm-up epoch and ``epochs`` timed ones, with the kernel's
    shapes recorded and the launch and path counts set to 0 just
    before. ``wave`` (``probes.one_wave``) splits the launches by N.
    The result holds the trained model under ``"model"``."""
    ds, dd, cfg = wl.ds, wl.dd, wl.cfg
    device = dd.device
    model = get_model(name, cfg, dd.num_users, dd.num_items, device=device)
    t0 = time.perf_counter()
    model._note_perms(dd)
    perms_s = time.perf_counter() - t0
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    block_chol.reset_launches()
    woodbury.reset_solve_paths()
    epoch_ms: List[float] = []
    with probes.recorded_chol_shapes() as shapes:
        probes.sync(device)
        t0 = time.perf_counter()
        model.initialize(dd)
        probes.sync(device)
        init_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(1 + epochs):
            t0 = time.perf_counter()
            model.train_epochs(dd, 1)
            probes.sync(device)
            epoch_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(block_chol.LAUNCHES)
    s = model.state
    timed = statistics.median(epoch_ms[1:]) if epochs else epoch_ms[0]
    return dict(
        model=model, name=name, dim=cfg.dim, block_size=cfg.block_size,
        perms_s=perms_s, init_ms=init_ms, warmup_ms=epoch_ms[0],
        epoch_ms=epoch_ms[1:], users_per_s=dd.num_users / timed * 1e3,
        paths=dict(woodbury.SOLVE_PATHS), launches=launches,
        shapes=shapes, calls=len(shapes),
        launch_histogram=(probes.launch_histogram(shapes, wave)
                          if wave else None),
        mean_dual=float(s.dual_weight.mean()),
        finite=bool(torch.isfinite(s.user_emb).all()
                    and torch.isfinite(s.item_emb).all()),
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if on_card else None),
        total_bytes=(torch.cuda.get_device_properties(device).total_memory
                     if on_card else None))


def describe_workload(wl: Workload) -> str:
    lay = layout(wl)
    return (f"{wl.dd.num_users} users x {wl.dd.num_items} items, "
            f"{wl.ds.nnz} tuples, dim {wl.cfg.dim}: Dataset "
            f"{wl.dataset_s:.2f} s, DeviceData.build {wl.build_s:.2f} s "
            f"(host); by side (buckets, wide, budget solve groups, widest) "
            + "; ".join(f"{side} {v['buckets']}, {v['wide']}, "
                        f"{v['solve_groups']}, {v['widest']}"
                        for side, v in lay.items()))


def describe(r: dict) -> str:
    """One line of a ``train`` result."""
    peak = ("not measured (CPU)" if r["peak_bytes"] is None else
            f"{r['peak_bytes']} B of {r['total_bytes']} B")
    hist = r["launch_histogram"]
    under = ("not measured (CPU)" if hist is None
             else {k: h["below_one_wave"] for k, h in hist.items()})
    return (f"{r['name']} dim {r['dim']}"
            + (f" block {r['block_size']}" if "pp" in r["name"] else "")
            + f": solver-order note {r['perms_s']:.2f} s; initialize "
            f"{r['init_ms']:.1f} ms; warm-up epoch {r['warmup_ms']:.1f} ms, "
            f"then {[round(t, 1) for t in r['epoch_ms']]} ms "
            f"({r['users_per_s']:.0f} users/s; synchronized host clock); "
            f"mean dual weight {r['mean_dual']:.4f}; finite tables "
            f"{r['finite']}; rows by path (padded rows; refreshes) "
            f"{r['paths']}; chol_inverse launches by r {r['launches']} "
            f"({r['calls']} wrapper calls), under one wave by r "
            f"{under}; peak device memory {peak}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num_users", type=int, nargs="?", default=NUM_USERS)
    ap.add_argument("num_items", type=int, nargs="?", default=NUM_ITEMS)
    ap.add_argument("dim", type=int, nargs="?", default=DIM)
    ap.add_argument("model", nargs="?", default=MODEL,
                    choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(device), flush=True)
    wl = build(args.num_users, args.num_items, args.dim, device)
    print(f"[scale] {describe_workload(wl)}", flush=True)
    wave = probes.one_wave(device) if device.type == "cuda" else None
    r = train(wl, args.model, args.epochs, wave)
    print(f"[scale] {describe(r)}", flush=True)
    return 0 if r["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
