"""What the drivers share: the benchmark's tables, the clock, the traced
window and what it hands the per-layer readers, and the comparison of
leaves."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from portbench.frozen import opclasses

TOP = 10          # entries of each breakdown list
GAPS_NAMED = 200  # the longest idle gaps attributed to a host op


def log(msg: str) -> None:
    """A progress line on standard error."""
    import sys
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now(device) -> float:
    """The host clock after the device has finished its queued work."""
    sync(device)
    return time.perf_counter()


def tables(seed: int, rows: int, dim: int, stdev: float, device
           ) -> torch.Tensor:
    """N(0, stdev / sqrt(dim)) float32 [rows, dim], drawn on ``device``
    in one call from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn((rows, dim), generator=gen, device=device,
                       dtype=torch.float32) * (stdev / dim ** 0.5)


class CholRecorder:
    """Records [N, r] of every ``chol_inverse_small`` call while active:
    the traced run alone places it around the port's kernel wrapper."""

    def __init__(self):
        self.calls: List[Tuple[int, int]] = []

    @contextlib.contextmanager
    def active(self):
        from safer2_recommender_tpu_torch.ops import block_chol

        orig = block_chol.chol_inverse_small

        def wrapped(a, ridge):
            self.calls.append((int(a.shape[0]), int(a.shape[1])))
            return orig(a, ridge)

        block_chol.chol_inverse_small = wrapped
        try:
            yield self
        finally:
            block_chol.chol_inverse_small = orig


def traced(fn: Callable[[], int], device) -> dict:
    """Run ``fn`` (which returns the units of work it did) under
    ``torch.profiler`` with input shapes, inside a ``window`` span, and
    hand the readers of ``portbench/metrics/`` what it saw:

    ``window_s``, ``busy_s``
        the traced window, and the union of device activity inside it;
    ``units``
        what ``fn`` returned (epochs);
    ``kernels``
        every device kernel as an ``opclasses.KernelRow``: the aten op
        that launched it, that op's input shapes, the kernel's name, its
        device ms and launches;
    ``host_ops``
        every host (CPU) op span that meets the window, as ``(name,
        start s, end s)`` from the window's start;
    ``chol_calls``
        ``(N, r)`` of every ``chol_inverse_small`` call;
    ``breakdown``
        the result line's ``breakdown``.

    The driver adds its own counters (``main_window_s``,
    ``main_units``, ``unit_flops``)."""
    from torch.profiler import ProfilerActivity, profile

    rec = CholRecorder()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof, rec.active():
        with torch.profiler.record_function("portbench.window"):
            t0 = time.perf_counter()
            units = fn()
            sync(device)
            wall = time.perf_counter() - t0
    t_read = time.perf_counter()
    events = prof.events()
    dev = opclasses.device_events(events)
    win = next(e for e in events if e.name == "portbench.window"
               and e.device_type.name == "CPU")
    lo, hi = win.time_range.start, win.time_range.end
    spans = [(max(e.time_range.start, lo) - lo,
              min(e.time_range.end, hi) - lo)
             for e in dev if e.time_range.end > lo and e.time_range.start < hi]
    host = [(e.name, (e.time_range.start - lo) / 1e6,
             (e.time_range.end - lo) / 1e6)
            for e in events if e.device_type.name == "CPU"
            and e.name != "portbench.window"
            and e.time_range.end > lo and e.time_range.start < hi]
    window_s = (hi - lo) / 1e6
    out = {"window_s": window_s,
           "busy_s": opclasses.union_ms(spans) / 1e6,
           "units": units, "kernels": opclasses.kernel_rows(events),
           "host_ops": host, "chol_calls": list(rec.calls),
           "breakdown": breakdown(dev, [(a / 1e6, b / 1e6) for a, b in spans],
                                  host, window_s)}
    log(f"traced window {wall:.2f} s, {len(events)} events read in "
        f"{time.perf_counter() - t_read:.1f} s")
    return out


def breakdown(dev, spans, host, window_s: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device (``spans``, s from the window's start) summed by
    the host op (``host``) that was running at their middle: the
    innermost one around it."""
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(opclasses.gaps(spans, 0.0, window_s),
                  key=lambda g: g[0] - g[1])
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    lens = ends - starts
    named = defaultdict(float)
    for a, b in idle[:GAPS_NAMED]:
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        name = ("(no host op)" if inside.size == 0 else
                host[inside[np.argmin(lens[inside])]][0])
        named[name] += b - a
    gaps_out = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_out]}


def leaf_gaps(prog: Dict[str, object], ref: Dict[str, torch.Tensor],
              start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf: ||program - reference|| over the reference's change from
    the start, ||reference - start||, in float64 on the reference's
    device; a leaf the reference leaves where it started is not read
    (None). ``prog``'s leaves may be host arrays."""
    out = {}
    for k, r in ref.items():
        r = r.to(torch.float64)
        moved = float(torch.linalg.vector_norm(
            r - start[k].to(r.device, torch.float64)))
        if moved == 0.0:
            out[k] = None
            continue
        p = torch.as_tensor(prog[k]).to(r.device, torch.float64)
        out[k] = float(torch.linalg.vector_norm(p - r)) / moved
        del p
    return out
