"""The device an entry point runs on, and the matmul precision it
computes in.

The port's entry points (``get_model``, ``Recommender``,
``DeviceData.build``, ``FoldInData.build``, the CLI) run on the card
unless the caller asks for the CPU. Without CUDA they raise; they never
fall back to the CPU on their own.

The JAX package asks for ``Precision.HIGHEST`` at each product where
near-ties must not reorder. PyTorch's precision is process-wide, so the
model's entry points run under ``f32_matmul()``, which turns TF32 off
for their duration and restores whatever the caller had set. It also
holds cuBLAS to float32 reductions in bfloat16 products
(``bf16_f32_reduction``): the JAX package accumulates every bfloat16
product in float32 (``preferred_element_type=jnp.float32``), while
cuBLAS may otherwise split a reduction and sum the parts in bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def _read(getter):
    """A legacy precision flag, or None where torch refuses to read it
    (a caller that mixed the legacy and the ``fp32_precision`` API)."""
    try:
        return getter()
    except RuntimeError:
        return None


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the body under ``torch.set_float32_matmul_precision(precision)``
    with cuDNN's TF32 off, then restore the caller's settings exactly.

    Both the legacy flags (``set_float32_matmul_precision``,
    ``cudnn.allow_tf32``) and the per-backend ``fp32_precision`` knobs of
    torch >= 2.9 that they map onto are saved and put back. The body sets
    them through the legacy calls only, which keep the two in step:
    torch refuses to read the legacy flags once they disagree."""
    be = torch.backends
    legacy = _read(torch.get_float32_matmul_precision)
    cudnn = _read(lambda: be.cudnn.allow_tf32)
    knobs = [(k, k.fp32_precision) for k in (
        getattr(be.cuda, "matmul", None), getattr(be.mkldnn, "matmul", None),
        getattr(be.cudnn, "conv", None), getattr(be.cudnn, "rnn", None))
        if hasattr(k, "fp32_precision")]
    torch.set_float32_matmul_precision(precision)
    be.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if cudnn is not None:
            be.cudnn.allow_tf32 = cudnn
        for knob, value in knobs:
            knob.fp32_precision = value


@contextlib.contextmanager
def bf16_f32_reduction():
    """Run the body with
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    off (bfloat16 GEMMs reduce in float32, split-K included), then
    restore the caller's setting."""
    knob = torch.backends.cuda.matmul
    prev = knob.allow_bf16_reduced_precision_reduction
    knob.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        knob.allow_bf16_reduced_precision_reduction = prev


@contextlib.contextmanager
def f32_matmul():
    """Full float32 products (no TF32 anywhere) and float32 reductions
    in bfloat16 products for the body; usable as a decorator
    (``@f32_matmul()``) or a ``with`` block."""
    with matmul_precision("highest"), bf16_f32_reduction():
        yield


class DeviceUnavailable(RuntimeError):
    """A CUDA device was asked for (or defaulted to) where CUDA is absent."""


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises
    ``DeviceUnavailable`` when ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {str(device)!r}: CUDA is not available (pass "
            f"device=\"cpu\", or --device cpu to the CLI, to run on the CPU)")
    return dev
