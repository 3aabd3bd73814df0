"""The controls of ``correct``: what each cell's numbers read when the
work is done in a lower precision than the configuration states, or with
a fault planted, each judged by the run's own ``judge`` against the
cell's limits, so that every limit sits between the program's sound
readings and these.

    python -m portbench.control --workload <name> --seeds <n> [<n> ...]

For a training cell, per seed, each compared with the float64 reference
exactly as a run compares the program:

``program_bf16``
    the program itself with its bf16 path switched on
    (``compute_dtype="bf16"``), through the run's own set-up and checked
    epochs;
``tf32``
    the reference put in the program's place, computed in float32 with
    TF32 matrix products (the nearest precision below the
    configuration's float32 with TF32 off);
``half_batch``
    the reference in float64 with half of the users left out of the U
    sweep and of the item side's sums.

A state left unchanged reads 1 on every leaf by construction and needs
no run. One JSON line per seed, each control with its numbers and its
``correct``, which has to read false. Runs on the card; the CPU tests
call ``main`` at a small size.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import sys
import time

import torch

from portbench import run as bench_run
from portbench.drivers import train
from portbench.reference.common import Prec


def _judged(cell, numbers: dict) -> dict:
    checks = bench_run.judge(cell.limits, numbers)
    return {"correct": all(c["ok"] for c in checks.values()),
            "checks": {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in checks.items()}}


def control(cell) -> dict:
    """The control readings of one seed of a training ``cell``."""
    low_cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config))
    low_cell.config["config"]["compute_dtype"] = "bf16"
    data, order, dd, model, bf16 = train.setup(low_cell)
    del model, dd
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    ref = train.reference_states(cell, data, order, Prec(torch.float64))
    ref_s = time.time() - t
    low = Prec(torch.float32, tf32=cell.device.type == "cuda")
    runs = {"program_bf16": bf16,
            "tf32": train.reference_states(cell, data, order, low),
            "half_batch": train.reference_states(
                cell, data, order, Prec(torch.float64), fault="half_batch")}
    out = {name: _judged(cell, train.compare(states, ref))
           for name, states in runs.items()}
    out["by_epoch"] = {name: train.epoch_gaps(states, ref)
                       for name, states in runs.items()}
    out["reference_s"] = ref_s
    return out


def main(argv=None, device=None, adjust=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = bench_run._load_json(bench_run.ROOT, "BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available():
            print("portbench.control: CUDA is not available",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    for seed in args.seeds:
        cell = bench_run.cell_for(bench, args.workload, seed, 0.0, False,
                                  device)
        if adjust is not None:
            adjust(cell)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control(cell)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
