"""Device probes of the port: small timing programs that measure one
kernel, op family or epoch phase on the GPU (counterparts of the JAX
package's ``scripts/probe_*.py``)."""

from __future__ import annotations

import torch


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
