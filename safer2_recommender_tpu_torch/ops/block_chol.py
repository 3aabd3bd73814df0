"""Batched SPD solve around a hand-written inverse-Cholesky kernel.

The counterpart of ``safer2_recommender_tpu/ops/block_chol.py``. Every
normal-equation solve of an ALS sweep is a batch of small SPD systems.
For d <= 64 the whole system goes through one CUDA kernel
(``csrc/chol_inverse.cu``) that computes ``inv(chol(a + diag(ridge)))``
with one thread per row, the system in registers (a group of warp lanes
for d <= 32, a block of two warps at 64); the solve is then two batched
mat-vecs. For d > 64 the blocked factorization of the JAX package
(``_factor_rec`` / ``_trsm_right`` / ``_fwd_sub`` / ``_bwd_sub``) runs as
batched torch products around the kernel on the <= 64 diagonal blocks.

``chol_inverse_small`` launches the kernel for a CUDA tensor (or
raises) and runs ``chol_inverse_small_ref``, its plain torch version,
for a CPU tensor; each call is a ``kernel.chol_inverse`` span (attrs N,
r). ``LAUNCHES`` counts kernel launches by block size.

Matrix products here run in full float32: PyTorch keeps TF32 off for
float32 matmuls unless a caller turns it on, and the solver needs the
JAX package's ``Precision.HIGHEST`` accuracy.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch

from safer2_recommender_tpu_torch import native
from safer2_recommender_tpu_torch.utils.logging import span

KERNEL_SIZES = (8, 16, 32, 64)
_SMALL_MAX = KERNEL_SIZES[-1]
_SRC = os.path.join(native.CSRC_DIR, "chol_inverse.cu")

# Kernel launches by block size r; a launch adds one, nothing else does.
LAUNCHES: Dict[int, int] = {r: 0 for r in KERNEL_SIZES}

_lib = None


def reset_launches() -> None:
    for r in KERNEL_SIZES:
        LAUNCHES[r] = 0


def total_launches() -> int:
    return sum(LAUNCHES.values())


def build_kernel():
    """Compile (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = native.build_cuda("chol_inverse", [_SRC])
        lib.frt_chol_inverse_f32.restype = ctypes.c_int
        lib.frt_chol_inverse_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.frt_chol_inverse_resident.restype = ctypes.c_int
        lib.frt_chol_inverse_resident.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def resident_systems(r: int) -> int:
    """Systems of size r one SM holds at once under the compiled
    kernel's occupancy; times the SM count, that is one wave."""
    out = ctypes.c_int(0)
    err = build_kernel().frt_chol_inverse_resident(r, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"chol_inverse occupancy query failed at r={r}: "
                           f"cudaError {err}")
    return out.value


def chol_inverse_small_ref(a: torch.Tensor,
                           ridge: torch.Tensor) -> torch.Tensor:
    """Plain torch ``inv(chol(a + diag(ridge)))`` for a [N, r, r],
    ridge [N, r], r <= 64: the column loop of the JAX package's
    ``_leaf_kernel``, batched. Step j adds the ridge to pivot j as the
    column is read, clamps the pivot at 1e-30 before the rsqrt, writes
    Cholesky column j with its rank-1 trailing update, and forms
    inverse row j = (e_j - L[j, :j] @ inv[:j]) * rsqrt(pivot)."""
    n, r, _ = a.shape
    blk = a.clone()
    inv = torch.zeros_like(a)
    for j in range(r):
        colv = blk[:, :, j].clone()
        colv[:, j] += ridge[:, j]
        inv_piv = torch.rsqrt(torch.clamp(colv[:, j], min=1e-30))
        col = colv * inv_piv[:, None]
        col[:, :j] = 0.0
        blk[:, :, j + 1:] -= col[:, :, None] * col[:, None, j + 1:]
        blk[:, :, j] = col
        prod = torch.einsum("nk,nkc->nc", blk[:, j, :j], inv[:, :j, :])
        rowv = -prod
        rowv[:, j] += 1.0
        inv[:, j, :] = rowv * inv_piv[:, None]
    return inv


def _check(a: torch.Tensor, ridge: torch.Tensor) -> int:
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"chol_inverse_small: a must be [N, r, r], "
                         f"got {tuple(a.shape)}")
    n, r, _ = a.shape
    if r not in KERNEL_SIZES:
        raise ValueError(f"chol_inverse_small: r={r} not in {KERNEL_SIZES}")
    if tuple(ridge.shape) != (n, r):
        raise ValueError(f"chol_inverse_small: ridge must be [{n}, {r}], "
                         f"got {tuple(ridge.shape)}")
    if a.dtype != torch.float32 or ridge.dtype != torch.float32:
        raise TypeError(f"chol_inverse_small: float32 only, got "
                        f"{a.dtype}/{ridge.dtype}")
    if a.device != ridge.device:
        raise ValueError(f"chol_inverse_small: a on {a.device}, ridge on "
                         f"{ridge.device}")
    if not (a.is_contiguous() and ridge.is_contiguous()):
        raise ValueError("chol_inverse_small: inputs must be contiguous")
    return r


def chol_inverse_small(a: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """``inv(chol(a + diag(ridge)))`` for contiguous float32 a [N, r, r],
    ridge [N, r], r in {8, 16, 32, 64}.

    A CUDA tensor goes through the sm_90a kernel, or this raises; a CPU
    tensor goes through ``chol_inverse_small_ref``."""
    r = _check(a, ridge)
    n = a.shape[0]
    with span("kernel.chol_inverse", N=n, r=r):
        if a.device.type == "cpu":
            return chol_inverse_small_ref(a, ridge)
        if a.device.type != "cuda":
            raise ValueError(f"chol_inverse_small: no kernel for {a.device}")
        lib = build_kernel()
        out = torch.empty_like(a)
        if n == 0:
            return out
        if a.data_ptr() % 16:
            a = a.clone()       # the kernel reads rows as float4
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.frt_chol_inverse_f32(a.data_ptr(), ridge.data_ptr(),
                                           out.data_ptr(), n, r, stream)
        if err != 0:
            raise RuntimeError(
                f"chol_inverse kernel launch failed at [N={n}, r={r}]: "
                f"cudaError {err}")
        LAUNCHES[r] += 1
        return out


# --------------------------------------------------------------------------
# spd_solve: pad, factor, substitute, scrub
# --------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _pad_to(a: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Pad [N, d, d] to [N, d_pad, d_pad] with identity on the new
    diagonal (the pad block decouples from the real one)."""
    n, d, _ = a.shape
    if d_pad == d:
        return a
    out = torch.zeros((n, d_pad, d_pad), dtype=a.dtype, device=a.device)
    out[:, :d, :d] = a
    idx = torch.arange(d, d_pad, device=a.device)
    out[:, idx, idx] = 1.0
    return out


def _trsm_right(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ L^-T for the solve factor ``s`` [N, r, r]; x [N, m, r]."""
    r = s.shape[1]
    if r <= _SMALL_MAX:
        return x @ s.transpose(1, 2)
    h = r // 2
    y1 = _trsm_right(s[:, :h, :h], x[:, :, :h])
    rest = x[:, :, h:] - y1 @ s[:, h:, :h].transpose(1, 2)
    y2 = _trsm_right(s[:, h:, h:], rest)
    return torch.cat([y1, y2], dim=2)


def _factor_rec(a: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """Solve factor of a + diag(ridge), r a power of two >= 8: the L21
    blocks below the diagonal and inv(chol(.)) on the <= 64 diagonal
    blocks."""
    n, r, _ = a.shape
    if r <= _SMALL_MAX:
        return chol_inverse_small(a.contiguous(), ridge.contiguous())
    h = r // 2
    s11 = _factor_rec(a[:, :h, :h], ridge[:, :h])
    l21 = _trsm_right(s11, a[:, h:, :h])
    s22 = _factor_rec(a[:, h:, h:] - l21 @ l21.transpose(1, 2),
                      ridge[:, h:])
    zero = torch.zeros((n, h, h), dtype=a.dtype, device=a.device)
    return torch.cat([torch.cat([s11, zero], dim=2),
                      torch.cat([l21, s22], dim=2)], dim=1)


def _fwd_sub(s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = L^-1 b by block forward substitution; b [N, r]."""
    r = s.shape[1]
    if r <= _SMALL_MAX:
        return (s @ b[:, :, None])[:, :, 0]
    h = r // 2
    y1 = _fwd_sub(s[:, :h, :h], b[:, :h])
    t = b[:, h:] - (s[:, h:, :h] @ y1[:, :, None])[:, :, 0]
    y2 = _fwd_sub(s[:, h:, h:], t)
    return torch.cat([y1, y2], dim=1)


def _bwd_sub(s: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x = L^-T y by block backward substitution; y [N, r]."""
    r = s.shape[1]
    if r <= _SMALL_MAX:
        return (s.transpose(1, 2) @ y[:, :, None])[:, :, 0]
    h = r // 2
    x2 = _bwd_sub(s[:, h:, h:], y[:, h:])
    t = y[:, :h] - (s[:, h:, :h].transpose(1, 2) @ x2[:, :, None])[:, :, 0]
    x1 = _bwd_sub(s[:, :h, :h], t)
    return torch.cat([x1, x2], dim=1)


def _scrub_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """Zero any solution row that came back nonfinite: a rank-deficient
    system with a nonzero diagonal defeats both the all-zero bump and
    the pivot clamp, and a zero row (skip this row's update) cannot
    poison the embedding table."""
    ok = torch.isfinite(x).all(dim=-1, keepdim=True)
    return torch.where(ok, x, torch.zeros_like(x))


def spd_solve(a: torch.Tensor, b: torch.Tensor,
              ridge: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Solve (a[n] + diag(ridge[n])) x = b[n] for batched SPD a
    [N, d, d], b [N, d] -> [N, d]; ridge None, [N] (a scalar shift per
    system) or [N, d] (a full diagonal shift).

    Systems whose right-hand side is all zero get the identity bump (for
    SPD a, b == 0 gives x == 0 with or without it; a == 0 only arises on
    padded rows, whose b is 0 too). d is padded to a power of two (at
    least 8, the kernel's smallest block) with identity blocks. The ridge
    and the bump ride the kernel's lazy diagonal shift. Rows that come
    out nonfinite are zeroed. One path serves every batch size: for
    d <= 64 the factor is the explicit inverse and the substitutions are
    two mat-vecs.
    """
    n, d = b.shape
    bump = (b == 0).all(dim=-1).to(a.dtype)
    if ridge is None:
        ridge = bump[:, None].expand(n, d)
    elif ridge.dim() == 1:
        ridge = (bump + ridge)[:, None].expand(n, d)
    else:
        ridge = bump[:, None] + ridge
    d_pad = max(_next_pow2(d), KERNEL_SIZES[0])
    if d_pad != d:
        a = _pad_to(a, d_pad)
        b = torch.nn.functional.pad(b, (0, d_pad - d))
        ridge = torch.nn.functional.pad(ridge, (0, d_pad - d))
    s = _factor_rec(a, ridge.to(a.dtype))
    x = _bwd_sub(s, _fwd_sub(s, b))
    return _scrub_nonfinite(x[:, :d])
