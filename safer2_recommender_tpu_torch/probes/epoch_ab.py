"""One SAFER2 epoch's eigh class and device kernel time in two trees of
the port, side by side on one card.

    python3 -m safer2_recommender_tpu_torch.probes.epoch_ab PARENT CHANGE \\
        [--workloads synth50k synth571k] [--out DIR (.build/epoch_ab)]

``PARENT`` and ``CHANGE`` are trees of the repository (a parent commit
unpacked by ``git archive`` into a directory that ``.gitignore`` lists).
For each workload it runs ``python3 -m
safer2_recommender_tpu_torch.probes.epoch_profile safer2 <workload>`` in
``PARENT``, ``CHANGE``, ``CHANGE``, ``PARENT`` in turn, each in a
process of its own with its tree first on ``PYTHONPATH``, writes each
run's output to ``DIR/<k>_<side>_<workload>.out`` and prints, per run,
the ``[classes]`` eigh row (ms an epoch of the two profiled epochs) and
the device kernel time of all classes. A run that fails, or prints
neither, makes the exit code 1.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import Optional, Tuple

ORDER = ("parent", "change", "change", "parent")
WORKLOADS = ("synth50k", "synth571k")
_EIGH = re.compile(r"^\[classes \S+\]\s+eigh\s+([0-9.]+) ms/epoch")
_ALL = re.compile(r"^\[classes \S+\] device kernel time ([0-9.]+) ms/epoch")


def readings(text: str) -> Tuple[Optional[float], Optional[float]]:
    """(eigh ms an epoch, all kernels ms an epoch) of an
    ``epoch_profile`` output, None where a line is missing."""
    eigh = total = None
    for line in text.splitlines():
        m = _EIGH.match(line)
        if m:
            eigh = float(m.group(1))
        m = _ALL.match(line)
        if m:
            total = float(m.group(1))
    return eigh, total


def run_one(tree: str, workload: str, out: str) -> Tuple[int, str]:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run(
        [sys.executable, "-m",
         "safer2_recommender_tpu_torch.probes.epoch_profile", "safer2",
         workload], cwd=tree, env=env, capture_output=True, text=True)
    with open(out, "w") as f:
        f.write(proc.stdout + proc.stderr)
    return proc.returncode, proc.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--workloads", nargs="+", default=list(WORKLOADS),
                    choices=("ml1m",) + WORKLOADS)
    ap.add_argument("--out", default=".build/epoch_ab")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    trees = {"parent": args.parent, "change": args.change}
    bad = 0
    for workload in args.workloads:
        for k, side in enumerate(ORDER, 1):
            out = os.path.join(args.out, f"{k}_{side}_{workload}.out")
            rc, text = run_one(trees[side], workload, out)
            eigh, total = readings(text)
            print(f"[epoch-ab] {workload} run {k} {side}: eigh "
                  f"{eigh} ms an epoch, all kernels {total} ms an epoch "
                  f"(rc {rc}; {out})", flush=True)
            bad += rc != 0 or eigh is None or total is None
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
