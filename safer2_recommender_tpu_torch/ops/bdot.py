"""Batched power of small square matrices around a hand-written CUDA
kernel (the counterpart of ``scripts/probe_bdot.py::pallas_bdot``, a
timing probe of the solver's mid-level batched dots):

    out = x^(n_dots + 1) * scale^n_dots

the value of the probe's chain ``acc = x; repeat n_dots times: acc =
(acc @ x) * scale``, computed by repeated squaring (4 products at 8
dots, where the chain runs 8).

``bdot`` launches ``csrc/bdot.cu`` for a CUDA tensor (or raises) and runs
``bdot_ref``, its plain torch version, for a CPU tensor. ``LAUNCHES``
counts kernel launches. ``precision`` mirrors the probe's: "highest" is
f32 accuracy (``Precision.HIGHEST``; three TF32 tensor-core passes in
the kernel), "default" one TF32 pass, the nearest analog on this card
of the TPU's DEFAULT single bf16 pass. ``bdot_ref`` multiplies with
``torch.bmm`` in f32 (TF32 off for float32 matmuls, PyTorch's default),
for "default" on operands rounded to TF32 as the kernel rounds them.
"""

from __future__ import annotations

import ctypes
import os

import torch

from safer2_recommender_tpu_torch import native

SIZES = (32, 64, 128)
# TF32 tensor-core passes per product at each precision
PASSES = {"highest": 3, "default": 1}
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
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        lib.frt_bdot_matrices_per_block.restype = ctypes.c_int
        lib.frt_bdot_matrices_per_block.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def matrices_per_block(h: int) -> int:
    """Matrices one block of the kernel holds at size h."""
    return build_kernel().frt_bdot_matrices_per_block(h)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, the low 13 mantissa bits cleared. On
    the bits, so it runs on any device."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _passes(precision) -> int:
    if not isinstance(precision, str) or precision not in PASSES:
        raise ValueError(f"bdot: precision must be one of {tuple(PASSES)}, "
                         f"got {precision!r}")
    return PASSES[precision]


def bdot_ref(x: torch.Tensor, n_dots: int, scale: float = 1e-2,
             precision: str = "highest") -> torch.Tensor:
    """Plain torch form, the kernel's arithmetic: ``torch.bmm`` in f32 by
    repeated squaring from the top bit of m = n_dots + 1 (square, then
    multiply by x where a bit is set), each product scaled once. Then
    y_a y_b scale = x^(a+b) scale^(a+b-1): the chain's value in exact
    arithmetic, in fewer products and another rounding order. For
    "default" each operand is rounded to TF32 first."""
    rnd = round_tf32 if _passes(precision) == 1 else (lambda t: t)
    m = n_dots + 1
    y = x
    for bit in range(m.bit_length() - 2, -1, -1):
        y = torch.bmm(rnd(y), rnd(y)) * scale
        if m >> bit & 1:
            y = torch.bmm(rnd(y), rnd(x)) * scale
    return x.clone() if y is x else y


def _check(x: torch.Tensor, n_dots: int, precision) -> tuple:
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"bdot: x must be [N, h, h], got {tuple(x.shape)}")
    h = x.shape[1]
    if h not in SIZES:
        raise ValueError(f"bdot: h={h} not in {SIZES}")
    if x.dtype != torch.float32:
        raise TypeError(f"bdot: float32 only, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bdot: x must be contiguous")
    if (isinstance(n_dots, bool) or not isinstance(n_dots, int)
            or not 0 <= n_dots < 2 ** 31 - 1):
        raise ValueError(f"bdot: n_dots must be an int in [0, 2^31 - 1), "
                         f"got {n_dots!r}")
    return h, _passes(precision)


def bdot(x: torch.Tensor, n_dots: int, scale: float = 1e-2,
         precision: str = "highest") -> torch.Tensor:
    """x^(n_dots + 1) * scale^n_dots for contiguous float32 x [N, h, h],
    h in {32, 64, 128}, at ``precision`` "highest" or "default".

    A CUDA tensor goes through the sm_90a kernel, or this raises; a CPU
    tensor goes through ``bdot_ref``."""
    global LAUNCHES
    h, passes = _check(x, n_dots, precision)
    if x.device.type == "cpu":
        return bdot_ref(x, n_dots, scale, precision)
    if x.device.type != "cuda":
        raise ValueError(f"bdot: no kernel for {x.device}")
    lib = build_kernel()
    if x.data_ptr() % 16:
        x = x.clone()       # the kernel reads rows as 16-byte vectors
    out = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.frt_bdot_f32(x.data_ptr(), out.data_ptr(), n, h, n_dots,
                               float(scale), passes, stream)
    if err != 0:
        raise RuntimeError(f"bdot kernel launch failed at [N={n}, h={h}, "
                           f"{precision}]: cudaError {err}")
    LAUNCHES += 1
    return out
