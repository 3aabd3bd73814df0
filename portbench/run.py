"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<traffic>.json``, whose ``driver`` names
the module of ``portbench/drivers/`` that runs it). The run sets up,
warms up, measures for ``--seconds`` and then checks what the timed path
produced against the plain reference (``portbench/reference/``), each
number compared against its limit (``portbench/limits/<workload>.json``).
With ``--trace 0`` it reports the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py``. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object.

The run needs as many CUDA devices as the cell asks for, and fails
(exit 1, no result) without them, or if JAX or the JAX package was
imported into this process.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# top-level module names no run may hold: JAX, its libraries, and the
# JAX package the port was made from (compared whole: the port's own
# name begins with the last)
FORBIDDEN = ("jax", "jaxlib", "flax", "safer2_recommender_tpu")
# host threads of a run: one process, few threads, so that the host side
# of a cell reads steadily on a host shared with others
HOST_THREADS = 2


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux /proc);
    the import of this module where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_IMPORT = time.time()
T_START = min(_process_start(), T_IMPORT)


class RunError(Exception):
    """A run that cannot report: no device, a missing file, JAX loaded."""


@dataclasses.dataclass
class Cell:
    """One run of one cell: what the drivers and readers read."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    end_to_end: List[dict]
    per_layer: List[dict]
    t_start: float = T_START

    def sub_seed(self, tag: str) -> int:
        """A seed of its own for each use of ``--seed`` (data, tables,
        draws), stable for a given seed and tag."""
        import hashlib
        h = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1


def _load_json(*parts) -> dict:
    path = os.path.join(*parts)
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as e:
        raise RunError(f"cannot read {os.path.relpath(path, ROOT)}: {e}")


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots
    and dashes, so it is loaded by path)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise RunError(f"no {kind} module portbench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_for(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _load_json(ROOT, configs[w["config"]]["file"])
    traffic = _load_json(HERE, "traffic", w["traffic"] + ".json")
    limits = _load_json(HERE, "limits", workload + ".json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m) and m["moves"] in names]
    return Cell(workload, cfg, traffic, limits, seed, seconds, trace, device,
                e2e, layer)


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def judge(limits: dict, numbers: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number is within it when it is
    finite and at most the limit."""
    out = {}
    for name, spec in limits["limits"].items():
        v = numbers.get(name)
        ok = v is not None and v == v and v <= spec["limit"]
        out[name] = {"value": v, "limit": spec["limit"], "ok": bool(ok)}
    return out


def run_cell(cell: Cell, chips: int) -> dict:
    """Set up, measure, check; returns the result object."""
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    res = driver.run(cell)
    checks = judge(cell.limits, res["numbers"])
    correct = res["failed"] == 0 and all(c["ok"] for c in checks.values())
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(res["trace"], cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in res["e2e"]}
    device = dict(res["device"])
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        out["breakdown"] = res["trace"]["breakdown"]
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def main(argv=None, device=None, adjust=None) -> int:
    """The command line. ``device`` and ``adjust`` are for the CPU tests
    alone: they pass ``torch.device("cpu")`` to skip the look for a card,
    and shrink the cell (``adjust(cell)``) to a size a test can hold."""
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = _load_json(ROOT, "BENCHMARK.json")
        chips = next((w["chips"] for w in bench["workloads"]
                      if w["name"] == args.workload), 1)
        import torch

        torch.set_num_threads(HOST_THREADS)
        if device is None:
            if not torch.cuda.is_available():
                raise RunError("CUDA is not available: the benchmark runs "
                               "only on the card")
            if torch.cuda.device_count() < chips:
                raise RunError(f"the cell needs {chips} CUDA devices, "
                               f"{torch.cuda.device_count()} are present")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
        cell = cell_for(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), device)
        if adjust is not None:
            adjust(cell)
        out = run_cell(cell, chips)
        found = forbidden_modules()
        if found:
            raise RunError(f"modules of JAX or the JAX package were "
                           f"imported: {', '.join(found)}")
    except (RunError, ImportError) as e:
        print(f"portbench: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # kernel and compiler caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".build", sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)
    sys.exit(main())
