"""The sound readings and the controls of ``correct`` for a cell whose
traffic runs ``drivers/train_hard.py`` (a hard indicator under the
near-tie rule), each "program" checked exactly as a run checks the
program: the float64 follower takes its z in the band, then the five
leaf gaps and ``z_outside_band`` are judged by the run's own ``judge``
against the cell's limits.

    python -m portbench.control_hard --workload <name> --seeds <n> ... \\
        [--runs sound program_bf16 tf32 half_batch]

``sound``
    the program as the cell runs it (its readings set each limit's
    ``lower`` and ``tau``: the largest relative loss error);
``program_bf16``
    the program with its bf16 path switched on (``compute_dtype=
    "bf16"``), through the run's own set-up and checked epochs;
``tf32``
    the reference put in the program's place, computed in float32 with
    TF32 matrix products (the nearest precision below the
    configuration's float32 with TF32 off);
``half_batch``
    the reference in float64 with half of the users left out of the U
    step and of the item side's sums.

Each but ``sound`` has to read ``correct`` false. One JSON line per
seed: per run its ``correct``, its checks, its numbers by epoch, and
per checked epoch the band's users, how many of them took the
program's z against the follower's own, the z outside it that differ,
and the largest relative loss error. Runs on the card; the CPU tests call
``main`` at a small size.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import sys

import torch

from portbench import run as bench_run
from portbench.drivers import train, train_hard
from portbench.reference.common import Prec

RUNS = ("sound", "program_bf16", "tf32", "half_batch")


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _program(cell, dtype=None) -> tuple:
    """(data, order, snapshots) of the program as the cell runs it, or
    at ``compute_dtype`` ``dtype``."""
    if dtype is not None:
        cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config))
        cell.config["config"]["compute_dtype"] = dtype
    data, order, dd, model, snaps = train.setup(cell)
    del model, dd
    _free(cell.device)
    return data, order, snaps


def _checked(cell, data, order, prog: list) -> dict:
    follower, stats = train_hard.follow(cell, data, order, prog,
                                        Prec(torch.float64))
    numbers = train_hard.judged(prog, follower, stats)
    checks = bench_run.judge(cell.limits, numbers)
    out = {"correct": all(c["ok"] for c in checks.values()),
           "checks": {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()},
           "by_epoch": train.epoch_gaps(prog, follower),
           "band": [{"users": s[3], "in_band": s[0], "taken": s[4],
                     "outside_differ": s[1], "rel_loss_error": s[2]}
                    for s in stats]}
    del follower
    _free(cell.device)
    return out


def control(cell, runs=RUNS) -> dict:
    """The readings of one seed of ``cell``."""
    out = {}
    data, order, sound = _program(cell)
    if "sound" in runs:
        out["sound"] = _checked(cell, data, order, sound)
    del sound
    if "program_bf16" in runs:
        _, _, bf16 = _program(cell, "bf16")
        out["program_bf16"] = _checked(cell, data, order, bf16)
        del bf16
    low = Prec(torch.float32, tf32=cell.device.type == "cuda")
    for name, prec, fault in (("tf32", low, None),
                              ("half_batch", Prec(torch.float64),
                               "half_batch")):
        if name in runs:
            prog = train.reference_states(cell, data, order, prec,
                                          fault=fault)
            out[name] = _checked(cell, data, order, prog)
            del prog
            _free(cell.device)
    return out


def main(argv=None, device=None, adjust=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.control_hard")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    args = p.parse_args(argv)
    bench = bench_run._load_json(bench_run.ROOT, "BENCHMARK.json")
    if device is None:
        if not torch.cuda.is_available():
            print("portbench.control_hard: CUDA is not available",
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
                          **control(cell, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
