"""Chained batched product of small square matrices around a
hand-written CUDA kernel (the counterpart of ``scripts/probe_bdot.py::
pallas_bdot``, a timing probe of the solver's mid-level batched dots).

    acc = x;  repeat n_dots times:  acc = (acc @ x) * scale

``bdot`` launches ``csrc/bdot.cu`` for a CUDA tensor (or raises) and
runs ``bdot_ref``, its plain torch version, for a CPU tensor.
``LAUNCHES`` counts kernel launches. The kernel computes in full f32
(the probe's ``Precision.HIGHEST``); ``bdot_ref`` matches it only with
TF32 off for float32 matmuls, which is PyTorch's default.
"""

from __future__ import annotations

import ctypes
import os

import torch

from safer2_recommender_tpu_torch import native

SIZES = (32, 64, 128)
_SRC = os.path.join(native.CSRC_DIR, "bdot.cu")

# Kernel launches; a launch adds one, nothing else does.
LAUNCHES = 0

_lib = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def build_kernel():
    """Compile (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = native.build_cuda("bdot", [_SRC])
        lib.frt_bdot_f32.restype = ctypes.c_int
        lib.frt_bdot_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        _lib = lib
    return _lib


def bdot_ref(x: torch.Tensor, n_dots: int,
             scale: float = 1e-2) -> torch.Tensor:
    """Plain torch form: chained ``torch.bmm``."""
    acc = x
    for _ in range(n_dots):
        acc = torch.bmm(acc, x) * scale
    return acc.clone() if n_dots == 0 else acc


def _check(x: torch.Tensor, n_dots: int) -> int:
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"bdot: x must be [N, h, h], got {tuple(x.shape)}")
    h = x.shape[1]
    if h not in SIZES:
        raise ValueError(f"bdot: h={h} not in {SIZES}")
    if x.dtype != torch.float32:
        raise TypeError(f"bdot: float32 only, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bdot: x must be contiguous")
    if isinstance(n_dots, bool) or not isinstance(n_dots, int) or n_dots < 0:
        raise ValueError(f"bdot: n_dots must be an int >= 0, got {n_dots!r}")
    return h


def bdot(x: torch.Tensor, n_dots: int, scale: float = 1e-2) -> torch.Tensor:
    """``n_dots`` chained products ``acc = (acc @ x) * scale`` from
    ``acc = x``, for contiguous float32 x [N, h, h], h in {32, 64, 128}.

    A CUDA tensor goes through the sm_90a kernel, or this raises; a CPU
    tensor goes through ``bdot_ref``."""
    global LAUNCHES
    h = _check(x, n_dots)
    if x.device.type == "cpu":
        return bdot_ref(x, n_dots, scale)
    if x.device.type != "cuda":
        raise ValueError(f"bdot: no kernel for {x.device}")
    lib = build_kernel()
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.frt_bdot_f32(x.data_ptr(), out.data_ptr(), n, h, n_dots,
                               float(scale), stream)
    if err != 0:
        raise RuntimeError(f"bdot kernel launch failed at [N={n}, h={h}]: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out
