"""Device probes of the port: small timing programs that measure one
kernel, op family or epoch phase on the GPU (counterparts of the JAX
package's ``scripts/probe_*.py``)."""

from __future__ import annotations

import re
import subprocess
from typing import Callable, Dict, List

import torch

from safer2_recommender_tpu_torch import native

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


def ptxas_report(src: str, kernel: str) -> List[str]:
    """What ``nvcc -Xptxas -v`` says of each kernel in ``src`` whose name
    matches the regular expression ``kernel``: one line per
    instantiation (``name<template ints>``) with its registers, shared
    memory, stack and spills."""
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
            m = re.search(rf"({kernel})(?:I((?:Li\d+E)+)E)?", entry.group(1))
            if m and m.group(2):
                args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
                name = f"{m.group(1)}<{args}>"
            else:
                name = m.group(1) if m else entry.group(1)
            lines[name] = []
        elif name and ("Used" in line or "spill" in line):
            lines[name].append(line.split("info    :")[-1].strip())
    return [f"{k}: {'; '.join(v)}" for k, v in lines.items()]
