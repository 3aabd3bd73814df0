"""The gradient sweeps' gather-matvec kernel on the GPU: its checks and
its times at an MSD-shape workload's buckets, beside its bounds and the
plain route it replaces.

    python -m safer2_recommender_tpu_torch.probes.grad_gather \\
        [--users N] [--items M] [--mean_hist H] [--dim D]

Defaults: the CVaR-MF cell's shape, 471,355 users x 41,140 items at
``data/synth.py::powerlaw_dataset(mean_hist=65)`` (log-normal lengths of
mean ~58.5, zipf-0.8 items: ~27.4M tuples, as the cell's ~27.77M), dim
512, bucketed by ``DeviceData.build`` on the card. Per side (the user
step gathers item rows with a dual weight by row; the item step user
rows with ``vec = z / |H|`` by column) it takes a bucket of each of the
three most frequent shapes (rows, width) and the bucket with the most
real slots, and for each:

* checks ``grad_gather.user_step`` / ``item_step`` against the plain route's step
  (``params_weighted_*``, ``grad_from_params``, ``scatter_bucket``)
  within 1e-5 of the plain step's largest entry;
* times in turns (CUDA events after warm-up; each call steps the same
  table again, warm in L2 as the sweep leaves it) the kernel route's
  bucket step (``x @ G`` and the launch) and the plain route's, and the
  kernel's own device time from a profile of 5 calls;
* gives two bounds at 3.35 TB/s: the gathered bytes (each real slot's
  row read once from device memory, which the user side's 84 MB item
  table partly serves from L2, so the kernel can beat it) and the
  compulsory bytes (each distinct gathered row, x, ``x @ G``, the new
  rows, the ids and weights once), with the kernel's share of the
  latter: its roofline.

Then ``nvcc -Xptxas -v``'s report of the kernels. The last line is one
JSON object. A machine without CUDA is an error.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

import numpy as np
import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import assemble, grad_gather

USERS, ITEMS, MEAN_HIST, DIM = 471_355, 41_140, 65, 512
UOBS, REG, ETA = 0.0004, 0.05, 0.4
CHECK_TOL = 1e-5


def pick(buckets, frequent: int = 3):
    """{label: (bucket, buckets of its shape)}: one bucket of each of the
    ``frequent`` most frequent (rows, width) shapes and the bucket with
    the most real slots."""
    shapes = Counter((b.n_rows, b.width) for b in buckets)
    out = {}
    for k, (shape, count) in enumerate(shapes.most_common(frequent)):
        out[f"frequent_{k + 1}"] = (
            next(b for b in buckets if (b.n_rows, b.width) == shape), count)
    largest = max(buckets, key=lambda b: int(b.length.sum()))
    out["largest"] = (largest, shapes[(largest.n_rows, largest.width)])
    return out


def bounds(b, d: int, by_column: bool) -> dict:
    """Gathered and compulsory bytes of one launch and their times."""
    slots = int(b.length.sum())
    pos = torch.arange(b.width, device=b.length.device)
    distinct = int(torch.unique(
        b.col_ids[pos[None, :] < b.length[:, None]]).numel())
    row = 4 * d
    gathered = slots * row
    compulsory = (distinct * (row + (4 if by_column else 0))
                  + 3 * b.n_rows * row + 8 * slots + 20 * b.n_rows)
    return {"slots": slots, "distinct_rows": distinct,
            "gathered_bytes": gathered, "compulsory_bytes": compulsory,
            "gathered_ms": gathered / probes.HBM_BYTES_PER_S * 1e3,
            "compulsory_ms": compulsory / probes.HBM_BYTES_PER_S * 1e3}


def kernel_ms(fn, calls: int = 5) -> float:
    """Device ms a call of the kernel(s) ``fn`` launches, from a
    profile of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from safer2_recommender_tpu_torch.probes.epoch_profile import (
        device_events, event_ms)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(event_ms(e) for e in device_events(prof.events())
               if "grad_gather" in e.name) / calls


def measure(side: str, b, table_self, table_other, by_row, by_column
            ) -> dict:
    """Check and time one bucket of one side."""
    d = table_other.shape[1]
    gram = table_other.T @ table_other

    def plain(table):
        rows = b.row_ids.clamp(max=by_row.shape[0] - 1)
        if side == "user":
            p = common.params_weighted_mean(
                table_other, b,
                torch.full((b.n_rows,), REG, device=table.device), UOBS,
                by_row[rows])
        else:
            p = common.params_weighted_item(table_other, b, by_row[rows],
                                            UOBS, by_column)
        x = assemble.read_rows(table, b)
        grad = common.grad_from_params(p, gram, x)
        return assemble.scatter_bucket(table, b, x - ETA * grad)

    def routed(table):
        if side == "user":
            return grad_gather.user_step(table, table_other, b, gram, ETA,
                                         reg=REG, uobs=UOBS, dual=by_row)
        return grad_gather.item_step(table, table_other, b, gram, ETA,
                                     reg=by_row, uobs=UOBS,
                                     norm_dual=by_column)

    got, want = routed(table_self.clone()), plain(table_self.clone())
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / (want - table_self).abs().max())
    row = {"side": side, "rows": b.n_rows, "width": b.width,
           "wide": assemble.is_wide(b, d),
           "splits": grad_gather.splits(b.width), "max_rel_err": err,
           "ok": err <= CHECK_TOL}
    row.update(bounds(b, d, side == "item"))
    work = table_self.clone()
    row.update(probes.in_turns({"step_ms": lambda: routed(work),
                                "plain_ms": lambda: plain(work)}))
    row["kernel_ms"] = kernel_ms(lambda: routed(work))
    row["gathered_gbps"] = row["gathered_bytes"] / row["kernel_ms"] / 1e6
    row["roofline_share"] = row["compulsory_ms"] / row["kernel_ms"]
    return row


def describe(row: dict) -> str:
    return (f"{row['side']} {row['label']} [{row['rows']} x {row['width']}]"
            f" ({row['count']} such, {row['slots']:,} slots, "
            f"{row['splits']} chunk(s){', wide' if row['wide'] else ''}): "
            f"kernel {row['kernel_ms']:.4f} ms, {row['gathered_gbps']:.0f} "
            f"GB/s of gathered rows (their bound from device memory "
            f"{row['gathered_ms']:.4f} ms), {100 * row['roofline_share']:.2f}"
            f"% of the compulsory bound {row['compulsory_ms']:.4f} ms; "
            f"bucket step {row['step_ms']:.4f} ms, plain route "
            f"{row['plain_ms']:.4f} ms; max err {row['max_rel_err']:.2e} of "
            f"the largest step")


def run(users=USERS, items=ITEMS, mean_hist=MEAN_HIST, dim=DIM,
        device="cuda") -> list:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probe measures the GPU; give a CUDA device")
    ds = Dataset(*powerlaw_dataset(users, items, mean_hist=mean_hist,
                                   seed=0))
    dd = DeviceData.build(ds, device=device, num_users=users,
                          num_items=items, dim=dim)
    print(f"[probe grad_gather] {ds.num_users:,} x {ds.num_items:,}, "
          f"{ds.nnz:,} tuples, dim {dim}; user buckets "
          f"{len(dd.by_user)}, item buckets {len(dd.by_item)}", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    scale = 0.1 / np.sqrt(dim)
    u = torch.randn((users, dim), generator=gen, device=device) * scale
    v = torch.randn((items, dim), generator=gen, device=device) * scale
    dual = (torch.rand((users,), generator=gen, device=device) < 0.3).float()
    item_reg = torch.rand((items,), generator=gen, device=device) / 10.0
    norm_dual = dual / 50.0
    rows = []
    for side, buckets, t_self, t_other, by_row in (
            ("user", dd.by_user, u, v, dual),
            ("item", dd.by_item, v, u, item_reg)):
        for label, (b, count) in pick(buckets).items():
            row = measure(side, b, t_self, t_other, by_row, norm_dual)
            row.update(label=label, count=count)
            print(f"[probe grad_gather] {describe(row)}", flush=True)
            rows.append(row)
    return rows


def ptxas_report() -> list:
    """``nvcc -Xptxas -v`` of the kernels' source, a line per kernel."""
    return probes.ptxas_report(grad_gather._SRC,
                               r"grad_gather_(?:sum_|dot_)?kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--users", type=int, default=USERS)
    ap.add_argument("--items", type=int, default=ITEMS)
    ap.add_argument("--mean_hist", type=int, default=MEAN_HIST)
    ap.add_argument("--dim", type=int, default=DIM)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    print(probes.nvidia_smi(), flush=True)
    rows = run(args.users, args.items, args.mean_hist, args.dim)
    for line in ptxas_report():
        print(f"[probe grad_gather] ptxas {line}", flush=True)
    print(json.dumps(rows))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
