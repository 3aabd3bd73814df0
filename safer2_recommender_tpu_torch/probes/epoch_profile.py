"""Where a dim-512 epoch spends its time on the GPU.

    python -m safer2_recommender_tpu_torch.probes.epoch_profile \\
        [model [workload]]

For each (workload, model) pair of ``RUNS`` (or ``model``, default
workload ``synth50k``, alone, as ``scripts/profile_pp512.py`` takes
one): SAFER2 on ML-1M (the
bundled ``tests/ml-1m`` split at the README config) and on the 50k x 40k
power-law set at the MSD config of ``bench.py`` (``synth50k``), then
SAFER2++ (block 64) on the latter, in frozen order and in the
reference's order (``safer2pp-interleaved``: ``block_interleaved``),
and CVaR-MF on it; last SAFER2 on the full synthetic MSD workload
(``synth571k``: ``probes/scale.py``, 571,355 x 41,140, ~20.3M tuples,
the MSD config); all at dim 512, seeded:

1. two warm-up epochs;
2. the model's own epoch three times from the same state (the state is
   not advanced) under ``torch.profiler``, with the median device ms of
   each of its phase spans and of the whole epoch printed
   (``utils/logging.py::EPOCH_PHASES``: SAFER2's and SAFER2++'s loss
   pass, xi line search, z-step, U sweep with its eigenbasis, V sweep
   with its weighted Gramian and eigenbasis, Gramian; the other models'
   epochs are not cut into phases);
3. ``torch.profiler`` over two more epochs: their wall time, the device
   busy time (the union of the device activity intervals, so
   overlapping streams are not counted twice) and its share of the
   wall time, and the device operations that took the most time;
4. two more epochs under ``torch.profiler`` with input shapes, each
   torch call annotated with the port's calling line, every device
   kernel sorted into the op classes of
   ``scripts/trace_classes.py`` (``CLASSES``, by the aten op that
   launched it: ``profile_classes``): ms per epoch, share and launches
   of each class, which sum to the device time of all kernels; the
   catch-all's constituents and its split by launching op, the port's
   calling line and the inputs' broadcast pattern (the counterpart
   of ``trace_classes.py``, ``trace_ops.py`` and ``profile_pp512.py``).

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
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import get_model
from safer2_recommender_tpu_torch.utils.logging import (EPOCH_PHASES,
                                                        clear_spans, spans)

DIM = 512
# (workload, model) pairs profiled, in order; no flags: edit this list
RUNS = (("ml1m", "safer2"), ("synth50k", "safer2"),
        ("synth50k", "safer2pp"), ("synth50k", "safer2pp-interleaved"),
        ("synth50k", "cvar_mf"), ("synth571k", "safer2"))
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
    """``"ml1m"``, ``"synth50k"`` or ``"synth571k"``: the training set,
    its device data and the config, at dim 512."""
    if name == "ml1m":
        ds, cfg = Dataset.from_csv(ML1M_TRAIN), ml1m_config()
    elif name == "synth50k":
        ds = Dataset(*powerlaw_dataset(50_000, 40_000, seed=0))
        cfg = msd_config()
    elif name == "synth571k":
        from safer2_recommender_tpu_torch.probes import scale

        wl = scale.build(scale.MSD_USERS, scale.MSD_ITEMS, DIM, device)
        return wl.ds, wl.dd, wl.cfg
    else:
        raise ValueError(f"unknown workload {name!r}")
    return ds, DeviceData.build(ds, device=device, dim=cfg.dim), cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_ms(model, dd: DeviceData, runs: int = 3) -> Dict[str, float]:
    """The model's own epoch, ``runs`` times from the same state (tables
    and the generator's draws) under ``torch.profiler``: the median ms
    of each phase span it ran (``EPOCH_PHASES``, in order), then
    of ``epoch``. On a CUDA device these are the spans' device ms; on
    the CPU, which finishes each op before the next starts, their host
    ms. Leaves the model's state as it was."""
    from torch.profiler import ProfilerActivity, profile

    state, draws = model.state, model.generator.get_state()
    ms = defaultdict(list)
    try:
        for _ in range(runs):
            model.state = state
            model.generator.set_state(draws)
            clear_spans()
            with profile(activities=[ProfilerActivity.CPU]):
                model.train_epochs(dd, 1)
            for s in spans():
                if s.name == "epoch" or s.name in EPOCH_PHASES:
                    ms[s.name].append(s.device_ms if s.device_ms is not None
                                      else (s.end - s.start) * 1e3)
    finally:
        model.state = state
        model.generator.set_state(draws)
        clear_spans()
    names = [n for n in EPOCH_PHASES if n in ms] + ["epoch"]
    return {n: statistics.median(ms[n]) for n in names}


def busy_ms(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def device_events(events):
    """The device activity of a profile's events (``prof.events()``):
    kernels, copies and sets, without CUPTI's own bookkeeping or user
    annotations."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.name not in _OVERHEAD]


def event_ms(e) -> float:
    return (e.time_range.end - e.time_range.start) / 1e3


def profile_epochs(model, dd: DeviceData):
    """Profile two epochs: (wall ms, device busy ms, the twelve device
    operations that took the most time, and every launch of the port's
    inverse-Cholesky kernel, each as (ms, count, name))."""
    from torch.profiler import ProfilerActivity, profile

    _sync(dd.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_epochs(dd, 2)
        _sync(dd.device)
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for e in device_events(prof.events()):
        spans.append((e.time_range.start / 1e3, e.time_range.end / 1e3))
        acc = by_name[e.name]
        acc[0] += event_ms(e)
        acc[1] += 1
    ranked = sorted(((t, n, name) for name, (t, n) in by_name.items()),
                    reverse=True)
    chol = [row for row in ranked if "chol_inverse" in row[2]]
    return wall, busy_ms(spans), ranked[:12], chol


# The op classes of ``scripts/trace_classes.py:16-28``, in the order a
# kernel is tested against them. A kernel belongs to the aten op that
# launched it (the profiler's CPU parent; kernel names differ between
# cuBLAS versions), or to the library routine around that op (eigh).
CLASSES = ("gather (slab rows)", "scatter (writeback)", "chol_inverse",
           "eigh", "batched Gramian products", "batched rhs products",
           "other GEMMs", "reductions", "dtype and layout copies",
           "elementwise and the rest")
CATCH_ALL = CLASSES[-1]
CLASS_EPOCHS = 2       # the epochs profile_classes profiles
TOP = 25               # the catch-all's constituents named, as trace_classes.py
_GATHER = {"aten::index", "aten::index_select", "aten::gather",
           "aten::take", "aten::embedding"}
_SCATTER = {"aten::index_put_", "aten::_index_put_impl_", "aten::index_put",
            "aten::index_copy_", "aten::index_copy", "aten::index_add_",
            "aten::index_add", "aten::scatter_", "aten::scatter",
            "aten::scatter_add_", "aten::scatter_add",
            "aten::scatter_reduce_", "aten::masked_scatter_"}
_BATCHED = {"aten::bmm", "aten::baddbmm"}
_GEMM = {"aten::mm", "aten::addmm", "aten::matmul", "aten::mv",
         "aten::addmv", "aten::dot", "aten::linear", "aten::_addmm_activation"}
_REDUCTION = {"aten::sum", "aten::mean", "aten::norm",
              "aten::linalg_vector_norm", "aten::cumsum", "aten::amax",
              "aten::amin", "aten::max", "aten::min", "aten::prod",
              "aten::any", "aten::all", "aten::argmax", "aten::argmin",
              "aten::std", "aten::var", "aten::logsumexp",
              "aten::count_nonzero"}
_COPY = {"aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
         "aten::contiguous"}
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SITE = "site: "       # the name prefix of a ``_Sites`` annotation


class KernelRow(NamedTuple):
    """Device kernels of one launching op: the op (None where no aten op
    launched them: the ctypes ``chol_inverse`` launch), its input shapes,
    the port's line that made the torch call (``"file.py(line):
    function"``, ``_Sites``), the kernel's name, ms and launches."""
    op: Optional[str]
    shapes: tuple
    site: str
    kernel: str
    ms: float
    launches: int = 1


def _batched_vector(shapes) -> bool:
    """Is a ``bmm`` / ``baddbmm`` on these input shapes a batch of
    matrix-vector products (a result [N, m, 1] or [N, 1, n])?"""
    mats = [s for s in shapes if len(s) == 3]
    if len(mats) < 2:
        return False
    a, b = mats[-2:]
    return a[1] == 1 or b[2] == 1


def op_class(op: Optional[str], shapes, kernel: str) -> str:
    """The class of ``CLASSES`` of a kernel launched by ``op``."""
    if kernel.startswith(("Memcpy", "Memset")):
        return "dtype and layout copies"
    if op is None:
        return "chol_inverse" if "chol_inverse" in kernel else CATCH_ALL
    if "eigh" in op:
        return "eigh"
    if op in _GATHER:
        return "gather (slab rows)"
    if op in _SCATTER:
        return "scatter (writeback)"
    if op in _BATCHED:
        return ("batched rhs products" if _batched_vector(shapes)
                else "batched Gramian products")
    if op in _GEMM:
        return "other GEMMs"
    if op in _REDUCTION:
        return "reductions"
    if op in _COPY:
        return "dtype and layout copies"
    return CATCH_ALL


def shape_pattern(shapes) -> str:
    """The broadcast pattern of an op's tensor inputs: each dim that is 1
    kept, every other one ``n`` (``[n, n, n] x [n, n, 1]``)."""
    return " x ".join("[" + ", ".join("1" if d == 1 else "n" for d in s)
                      + "]" for s in shapes if s)


def classify(rows: Sequence[KernelRow]) -> dict:
    """Sum ``rows`` by class: ``{"classes": {name: {"ms", "launches",
    "share"}}, "total_ms", "catch_all": [(ms, launches, "op: kernel")]
    (its ``TOP`` largest), "elementwise": [(ms, launches, op, site,
    pattern, example shapes)] (the catch-all by launching op, site and
    input broadcast pattern), "unparented_ms"}``."""
    classes = {c: {"ms": 0.0, "launches": 0} for c in CLASSES}
    catch, split = defaultdict(lambda: [0.0, 0]), {}
    unparented = 0.0
    for r in rows:
        c = op_class(r.op, r.shapes, r.kernel)
        classes[c]["ms"] += r.ms
        classes[c]["launches"] += r.launches
        unparented += r.ms if r.op is None else 0.0
        if c != CATCH_ALL:
            continue
        acc = catch[f"{r.op or '(no aten op)'}: {r.kernel}"]
        acc[0] += r.ms
        acc[1] += r.launches
        key = (r.op or "(no aten op)", r.site, shape_pattern(r.shapes))
        e = split.setdefault(key, [0.0, 0, {}])
        e[0] += r.ms
        e[1] += r.launches
        shp = str([list(x) for x in r.shapes if x])
        e[2][shp] = e[2].get(shp, 0.0) + r.ms
    total = sum(v["ms"] for v in classes.values())
    for v in classes.values():
        v["share"] = v["ms"] / total if total else 0.0
    return {
        "classes": classes, "total_ms": total, "unparented_ms": unparented,
        "catch_all": sorted(((ms, n, name) for name, (ms, n) in
                             catch.items()), reverse=True)[:TOP],
        "elementwise": sorted(((ms, n, op, site, pat,
                                max(ex, key=ex.get))
                               for (op, site, pat), (ms, n, ex)
                               in split.items()), reverse=True)[:TOP]}


def _launching_op(event) -> str:
    """``event``'s name, or that of the eigh routine around it."""
    e = event
    while e is not None:
        if e.name.startswith("aten::") and "eigh" in e.name:
            return e.name
        e = e.cpu_parent
    return event.name


class _Sites(TorchFunctionMode):
    """Wraps every torch call made from the port's code in a profiler
    annotation named ``_SITE`` + ``"file.py(line): function"``: the
    innermost frame of the port that made the call, at the calling line.
    The profiler's own Python stacks are not recorded on every torch
    build (torch 2.11 on the card records none), and the launching op's
    inputs alone cannot tell, for one, the broadcast products over a
    gathered slab apart."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        f = sys._getframe(1)
        while f is not None and not (
                f.f_code.co_filename.startswith(_PACKAGE)
                and os.sep + "probes" + os.sep not in f.f_code.co_filename):
            f = f.f_back
        if f is None:
            return func(*args, **kwargs)
        rel = os.path.relpath(f.f_code.co_filename, _PACKAGE)
        with torch.profiler.record_function(
                f"{_SITE}{rel}({f.f_lineno}): {f.f_code.co_name}"):
            return func(*args, **kwargs)


def _site(event) -> str:
    """The ``_Sites`` annotation around ``event``, or ``""``."""
    e = event.cpu_parent
    while e is not None:
        if e.name.startswith(_SITE):
            return e.name[len(_SITE):]
        e = e.cpu_parent
    return ""


def kernel_rows(events) -> List[KernelRow]:
    """Every device kernel of a profile's events (``prof.events()``) as
    a ``KernelRow``: the kernels each aten op launched (the profiler
    links them to it), then, by kernel name, the device time no aten op
    launched. A kernel linked to an op but missing from the device
    events (CUPTI dropped a record) stays in its op's row, so the rows
    sum to more than the device events: ``profile_classes``' ``gap``."""
    from torch.autograd import DeviceType

    device = defaultdict(lambda: [0.0, 0])
    for e in device_events(events):
        device[e.name][0] += event_ms(e)
        device[e.name][1] += 1
    rows, linked, seen = [], defaultdict(lambda: [0.0, 0]), set()
    for e in events:
        # the profiler appends a kernel to every CPU event of its
        # correlation id: aten ops only, each id once
        if (e.device_type != DeviceType.CPU or not e.kernels
                or not e.name.startswith("aten::") or e.id in seen):
            continue
        seen.add(e.id)
        op, site = _launching_op(e), _site(e)
        shapes = tuple(tuple(s) for s in e.input_shapes or ())
        for k in e.kernels:
            if k.name in _OVERHEAD:
                continue
            rows.append(KernelRow(op, shapes, site, k.name, k.duration / 1e3))
            linked[k.name][0] += k.duration / 1e3
            linked[k.name][1] += 1
    for name, (ms, n) in device.items():
        rest_ms, rest_n = ms - linked[name][0], n - linked[name][1]
        if rest_n > 0:
            rows.append(KernelRow(None, (), "", name, rest_ms, rest_n))
    return rows


def profile_classes(model, dd: DeviceData) -> dict:
    """``CLASS_EPOCHS`` epochs under ``torch.profiler`` with input shapes and
    the port's calling lines (``_Sites``): ``classify`` of their kernels,
    beside the device time of all their kernels summed apart
    (``kernel_ms``), their relative difference (``gap``) and
    ``epochs``, the number profiled."""
    from torch.profiler import ProfilerActivity, profile

    _sync(dd.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, _Sites():
        model.train_epochs(dd, CLASS_EPOCHS)
        _sync(dd.device)
    events = prof.events()
    out = classify(kernel_rows(events))
    out["kernel_ms"] = sum(event_ms(e) for e in device_events(events))
    out["epochs"] = CLASS_EPOCHS
    # the classes' sum against the kernels summed apart (0 where the
    # profile holds no device kernel)
    out["gap"] = (out["total_ms"] / out["kernel_ms"] - 1 if out["kernel_ms"]
                  else float(out["total_ms"] != 0))
    return out


def describe_classes(t: dict) -> List[str]:
    """The class table of ``profile_classes``: ms per epoch, share and
    launches of each class, the unparented time, the catch-all's
    constituents and its split by launching op, site and shape."""
    n = t["epochs"]
    lines = [f"device kernel time {t['kernel_ms'] / n:.3f} ms/epoch over "
             f"{n} epochs; classes sum to {t['total_ms'] / n:.3f} "
             f"({100 * t['gap']:+.4f}%); "
             f"launched by no aten op {t['unparented_ms'] / n:.3f} ms/epoch"]
    for c, v in t["classes"].items():
        lines.append(f"  {c:26s} {v['ms'] / n:9.3f} ms/epoch "
                     f"{100 * v['share']:5.1f}% {v['launches'] / n:8.1f} "
                     f"launches/epoch")
    lines.append(f"catch-all ({CATCH_ALL}) constituents, top "
                 f"{len(t['catch_all'])}:")
    lines += [f"  {ms / n:9.3f} ms/epoch x{k / n:7.1f}  {name[:100]}"
              for ms, k, name in t["catch_all"]]
    lines.append("catch-all by launching op, site and input broadcast "
                 "pattern (largest example shapes):")
    lines += [f"  {ms / n:9.3f} ms/epoch x{k / n:7.1f}  {op} at "
              f"{site or '?'} {pat} e.g. {ex}"
              for ms, k, op, site, pat, ex in t["elementwise"]]
    return lines


def run(runs=RUNS) -> Dict[str, dict]:
    """Measure and print every (workload, model) pair of ``runs`` on the
    current CUDA device; returns the numbers by ``"<workload>"`` (SAFER2)
    or ``"<workload>-<model>"``."""
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for wl, model_name in runs:
        name = wl if model_name == "safer2" else f"{wl}-{model_name}"
        ds, dd, cfg = workload(wl, device)
        base = model_name.removesuffix("-interleaved")
        cfg = cfg.replace(block_interleaved=base != model_name)
        model = get_model(base, cfg, ds.num_users, ds.num_items,
                          device=device)
        model.initialize(dd)
        model.train_epochs(dd, 2)
        med = phase_ms(model, dd)
        print(f"[profile {name}] phase device ms, median of 3 from one "
              "state: " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()),
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
        classes = profile_classes(model, dd)
        for line in describe_classes(classes):
            print(f"[classes {name}] {line}", flush=True)
        out[name] = dict(phase_ms=med, wall_ms=wall, busy_ms=busy,
                         top=[dict(ms=ms, count=c, name=op)
                              for ms, c, op in ranked],
                         chol_inverse=[dict(ms=ms, count=c, name=op)
                                       for ms, c, op in chol],
                         classes=classes)
        del model, dd
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import argparse

    from safer2_recommender_tpu_torch.models import MODEL_REGISTRY

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", choices=sorted(
        list(MODEL_REGISTRY) + [f"{m}-interleaved" for m in
                                ("safer2pp", "ialspp")]),
                    help="profile this model alone (default: every pair "
                         "of RUNS)")
    ap.add_argument("workload", nargs="?", default="synth50k",
                    choices=("ml1m", "synth50k", "synth571k"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    run(((args.workload, args.model),) if args.model else RUNS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
