"""Device probes of the port: small timing programs that measure one
kernel, op family or epoch phase on the GPU (counterparts of the JAX
package's ``scripts/probe_*.py``)."""

from __future__ import annotations

import contextlib
import gc
import re
import subprocess
import time
from typing import Callable, Dict, List

import torch

from safer2_recommender_tpu_torch import native
from safer2_recommender_tpu_torch.ops import block_chol

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): device memory
# rate, the f32 rate outside the tensor cores, and the dense TF32 rate of
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_TENSOR_FLOP_PER_S = 495e12


def bound(nbytes: float, flop: float,
          flop_per_s: float = F32_FLOP_PER_S) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flop`` operations at ``flop_per_s``: the larger of the two times,
    and which."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flop / flop_per_s * 1e3
    return {"bytes": nbytes, "flop": flop, "bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: Dict[str, Callable],
             timer: Callable = cuda_ms) -> Dict[str, float]:
    """Each callable timed by ``timer`` once in order and once in
    reverse (plain, kernel, kernel, plain for two); the better reading of
    each."""
    names = list(fns)
    best: Dict[str, float] = {}
    for name in names + names[::-1]:
        ms = timer(fns[name])
        best[name] = min(ms, best.get(name, ms))
    return best


def graph_ms(fn: Callable, calls: int = 20) -> float:
    """Device ms per call of ``fn``, replayed from a CUDA graph of
    ``calls`` calls: the kernel's own time, without the host's launch
    overhead that ``cuda_ms`` includes for short launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=5, warmup=1) / calls


# The chain lengths ``chain_ms`` differences (scripts/probe_seqdot.py's)
CHAIN_KS = (16, 128)


def chain_ms(step: Callable, x0: torch.Tensor) -> float:
    """Device ms of one step of the dependent chain x <- step(x) from
    ``x0``: a CUDA graph of k steps replayed at each k of ``CHAIN_KS``,
    the difference of the two over the difference of the k (the JAX
    scripts' scan-length differencing, without the host's launches)."""
    def chain(k):
        def run():
            x = x0
            for _ in range(k):
                x = step(x)
            return x
        return run

    lo, hi = (graph_ms(chain(k), calls=1) for k in CHAIN_KS)
    return (hi - lo) / (CHAIN_KS[1] - CHAIN_KS[0])


def host_reads(fn: Callable) -> int:
    """Synchronizing CUDA calls (the host waiting on the card, a read
    back included) made by one call of ``fn``, as torch's sync debug
    mode reports them; call ``fn`` once before, so that one-time set-up
    is not counted."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum("synchroniz" in str(w.message) for w in caught)


def kernel_names(fn: Callable) -> List[str]:
    """The device kernels that one call of ``fn`` ran, the longest
    first (``torch.profiler``); empty if three profiles of a call
    recorded no device event (late in a long process the profiler
    sometimes records none for a short call)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from safer2_recommender_tpu_torch.probes.epoch_profile import (
        device_events, event_ms)

    ms: Counter = Counter()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in device_events(prof.events()):
            ms[e.name] += event_ms(e)
        if ms:
            break
    return [name for name, _ in ms.most_common()]


def describe_kernels(names: List[str], top: int = 2) -> str:
    """The first ``top`` kernel names, shortened, or "not recorded"."""
    return ", ".join(k[:60] for k in names[:top]) or "not recorded"


def ptxas_report(src: str, kernel: str) -> List[str]:
    """What ``nvcc -Xptxas -v`` says of each kernel in ``src`` whose name
    matches the regular expression ``kernel``: one line per
    instantiation (``name<template ints>``, a bool as 0 or 1) with its
    registers, shared memory, stack and spills."""
    cmd = [native.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-cubin", "-o", "/dev/null",
           src]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise native.BuildError(res.stdout + res.stderr)
    lines: Dict[str, List[str]] = {}
    name = None
    for line in (res.stdout + res.stderr).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(rf"({kernel})(?:I((?:L[ib]\d+E)+)E)?",
                          entry.group(1))
            if m and m.group(2):
                args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(2)))
                name = f"{m.group(1)}<{args}>"
            else:
                name = m.group(1) if m else entry.group(1)
            lines[name] = []
        elif name and ("Used" in line or "spill" in line):
            lines[name].append(line.split("info    :")[-1].strip())
    return [f"{k}: {'; '.join(v)}" for k, v in lines.items()]


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def release_graphs() -> None:
    """Free what models and Servers no longer referenced hold: a
    Server's programs refer back to it, a cycle only the collector
    breaks, and its graph pool lives until then."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device):
    """``(fn(), ms)``: one call of ``fn`` on a host clock between two
    ``sync``s of ``device``."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def recorded_chol_shapes():
    """Record the [N, r, r] shapes the code run while open hands the
    inverse-Cholesky wrapper (``block_chol.chol_inverse_small``, looked
    up by ``spd_solve`` at each call). The shim counts nothing; the
    wrapper's ``LAUNCHES`` does."""
    shapes, wrapper = [], block_chol.chol_inverse_small

    def recording(a, ridge):
        shapes.append(tuple(a.shape))
        return wrapper(a, ridge)

    block_chol.chol_inverse_small = recording
    try:
        yield shapes
    finally:
        block_chol.chol_inverse_small = wrapper


def one_wave(device) -> Dict[int, int]:
    """Systems of each size r the card holds at once (SMs x systems
    resident on one), by r; the kernel is built to ask its occupancy."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {r: sms * block_chol.resident_systems(r)
            for r in block_chol.KERNEL_SIZES}


def launch_histogram(shapes, wave) -> Dict[int, dict]:
    """{r: {"launches", "below_one_wave", "one_wave", "n_bins":
    {"[lo, hi)": count}}} of recorded [N, r, r] shapes; ``wave[r]`` is
    ``one_wave``'s."""
    hist: Dict[int, dict] = {}
    for n, r, _ in shapes:
        h = hist.setdefault(r, {"launches": 0, "below_one_wave": 0,
                                "one_wave": wave[r], "n_bins": {}})
        h["launches"] += 1
        h["below_one_wave"] += n < wave[r]
        lo = 1 << max(n, 1).bit_length() - 1
        key = f"[{lo}, {2 * lo})"
        h["n_bins"][key] = h["n_bins"].get(key, 0) + 1
    return {r: hist[r] for r in sorted(hist)}
