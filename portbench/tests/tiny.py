"""A size at which every cell runs on the CPU in seconds: the same
code paths (dim 128 takes the Woodbury and, for the ++ model, the exact
and the block routes), few rows."""

from __future__ import annotations

import io
import json
import contextlib

import torch

SEED = 2 ** 31 + 17


def adjust(cell) -> None:
    ds = cell.config["dataset"]
    ds.update(users=700, items=300, interactions=700 * 40,
              heldout_users=100, min_hist=5, max_hist=150)
    cell.config["config"].update(dim=128, block_size=32)
    cell.traffic.update(trace_epochs=1)


def run(module, workload: str, seed: int = SEED, trace: int = 0,
        seconds: float = 0.5, adjust_fn=adjust):
    """(exit code, last stdout line as an object or None, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(["--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         device=torch.device("cpu"), adjust=adjust_fn)
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, err.getvalue()
