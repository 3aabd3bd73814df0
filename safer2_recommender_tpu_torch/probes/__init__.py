"""Device probes of the port: small timing programs that measure one
kernel, op family or epoch phase on the GPU (counterparts of the JAX
package's ``scripts/probe_*.py``)."""

from __future__ import annotations

import torch

# One H100 SXM at its 700 W limit (NVIDIA's data sheet): device memory
# rate and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound(nbytes: float, flop: float) -> dict:
    """The least time the card could take for work that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flop`` f32 operations: the larger of the two times, and which."""
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flop / F32_FLOP_PER_S * 1e3
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
