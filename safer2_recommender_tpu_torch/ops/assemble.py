"""Normal-equation assembly over padded buckets (the counterpart of
``safer2_recommender_tpu/ops/assemble.py``).

For a bucket of N rows whose histories are padded to L columns,

    A_hist[n] = sum_{l < len(n)} v_{n,l} v_{n,l}^T
             == einsum('nld,nle->nde', Vh, Vh)       (one batched matmul)

Pad rows carry the out-of-bounds id ``num_rows``: JAX drops writes to
it and clamps reads of it, torch raises, so every read or write here
masks or clamps pad rows first. Buckets whose gathered slab would not
fit in memory ("wide", zipf-head histories) stream through column
chunks (``wide_chunks``, ``wide_assemble``, ``wide_matvec``,
``wide_gram_resid``, ``wide_obs``); the models never gather them whole.

``dtype`` (None or ``torch.bfloat16``) is the assembly dtype of the JAX
package's ``compute_dtype="bf16"``, rounded where that package rounds:
the TABLE is cast before the gather (so is a per-row scalar gathered
beside it), and a column weight is cast to the slab's dtype before it
multiplies the slab. The products of a bfloat16 slab accumulate in
float32 and come out in float32 (``row_gramians``, ``row_sums``,
``bmm_f32``); ``matmul_lowp`` is the one product that comes out in the
slab's dtype (the rotations into an eigenbasis). The rounding of a
weighted operand of a float32-accumulating product follows the route
(``weight_operand``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from safer2_recommender_tpu_torch.data.dataset import Bucket
from safer2_recommender_tpu_torch.utils.logging import span

WIDE_SLAB_BYTES = 768 << 20
WIDE_CHUNK = 4096


def is_wide(bucket: Bucket, dim: int) -> bool:
    """Stream this bucket through column chunks? Only when the *width*
    is the problem (width > dim keeps it off the Woodbury path; narrow
    slabs are bounded by build-time chunking). Decided on the whole
    bucket's shape, on a mesh too (``Bucket.global_rows``)."""
    return bucket.width > dim and (
        bucket.global_rows * bucket.width * (dim + 1) * 4 > WIDE_SLAB_BYTES)


def history_mask(bucket: Bucket) -> torch.Tensor:
    """[N, L] float32 mask of valid (non-padding) history slots."""
    pos = torch.arange(bucket.width, device=bucket.length.device)
    return (pos[None, :] < bucket.length[:, None]).to(torch.float32)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in ``dtype`` (None keeps it; a tensor already in ``dtype``
    is returned as it is, so a caller may cast a table once per sweep)."""
    return x if dtype is None else x.to(dtype)


def gather_history(table: torch.Tensor, bucket: Bucket,
                   dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the other-side embedding rows for each history slot.
    Returns (emb [N, L, d] already masked, in ``dtype`` or the table's,
    mask [N, L] f32)."""
    mask = history_mask(bucket)
    table = cast(table, dtype)
    emb = table[bucket.col_ids] * mask[..., None].to(table.dtype)
    return emb, mask


def gather_history_extra(table: torch.Tensor, vec: torch.Tensor,
                         bucket: Bucket, dtype=None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row gather of the embedding rows and a per-row scalar: returns
    (emb [N, L, d] masked, mask [N, L], extra [N, L] f32 masked) with
    ``extra[n, l] = vec[col_ids[n, l]]`` rounded to the slab's dtype (the
    JAX package gathers it as one more column of the cast table)."""
    mask = history_mask(bucket)
    table = cast(table, dtype)
    emb = table[bucket.col_ids] * mask[..., None].to(table.dtype)
    return emb, mask, history_extra(vec, bucket, table.dtype, mask)


def history_extra(vec: torch.Tensor, bucket: Bucket, dtype,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gather_history_extra``'s per-slot scalar alone: [N, L] f32,
    masked, ``vec[col_ids]`` rounded to ``dtype``."""
    if mask is None:
        mask = history_mask(bucket)
    return vec[bucket.col_ids].to(dtype).to(torch.float32) * mask


def gram_route(device) -> str:
    """How ``bmm_f32`` multiplies bfloat16 operands on ``device``:
    ``"out_dtype"``, one ``torch.bmm(a, b, out_dtype=torch.float32)``
    (bfloat16 operands, float32 accumulation and result), on a CUDA
    device whose torch has ``aten::bmm.dtype``; ``"upcast"`` otherwise:
    the operands copied to float32 and multiplied in float32, which is
    exact product for product (a bfloat16 x bfloat16 product fits in
    float32). The CPU has no ``aten::bmm.dtype`` kernel."""
    if torch.device(device).type == "cuda" and \
            "dtype" in torch.ops.aten.bmm.overloads():
        return "out_dtype"
    return "upcast"


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(a, b)`` in float32: float32 operands as they are,
    bfloat16 ones by ``gram_route``."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if gram_route(a.device) == "out_dtype":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def matmul_lowp(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``x @ q`` with ``q`` cast to ``x``'s dtype and the result in it:
    the JAX package's ``preferred_element_type=compute_dtype`` product
    (float32 accumulation, then one rounding). On the card a bfloat16
    GEMM (its reduction pinned to float32 by the entry points,
    ``utils/device.py::bf16_f32_reduction``); on the CPU the rounded
    operands are multiplied in float32 and the result rounded."""
    q = q.to(x.dtype)
    if x.dtype == torch.float32 or x.is_cuda:
        return x @ q
    return (x.to(torch.float32) @ q.to(torch.float32)).to(x.dtype)


def weight_operand(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x * weight`` with ``weight`` cast to ``x``'s dtype first: the
    weighted operand of a float32-accumulating product. For a bfloat16
    ``x`` it is bfloat16 (the product rounded) on the ``"out_dtype"``
    route, whose tensor cores take bfloat16 operands as the TPU's MXU
    does, and the exact product in float32 on the ``"upcast"`` route,
    which is what XLA's CPU backend computes for the JAX package's
    ``row_gramians`` (so the CPU tests can hold the port to it)."""
    w = weight.to(x.dtype)
    if x.dtype != torch.float32 and gram_route(x.device) == "upcast":
        return x.to(torch.float32) * w.to(torch.float32)
    return x * w


def row_gramians(emb: torch.Tensor,
                 col_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched sum of weighted outer products: [N, L, d] -> [N, d, d]
    f32; the weight multiplies one operand (``weight_operand``)."""
    lhs = emb if col_weight is None else weight_operand(
        emb, col_weight[..., None])
    return bmm_f32(lhs.transpose(1, 2), emb)


def row_sums(emb: torch.Tensor,
             col_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched weighted rhs accumulation: [N, L, d] -> [N, d], summed in
    f32 (the weight cast to the slab's dtype, as in ``row_gramians``)."""
    lhs = emb if col_weight is None else (
        emb * col_weight[..., None].to(emb.dtype))
    return lhs.sum(dim=1, dtype=torch.float32)


def rowwise_dot(emb: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Per-slot dots: [N, L, d] x [N, d] -> [N, L] (f32 for a bfloat16
    slab: the product promotes, as in the JAX package)."""
    return (emb * vec[:, None, :]).sum(dim=2)


# --------------------------------------------------------------------------
# Column-chunked ("wide") assembly for very long histories
# --------------------------------------------------------------------------


def wide_chunks(table: torch.Tensor, vec: Optional[torch.Tensor],
                bucket: Bucket, dtype=None
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]]:
    """Yield ``(emb [N, W, d] masked, mask [N, W], extra [N, W] or None)``
    for consecutive column chunks of ``bucket``, left to right
    (``extra[n, l] = vec[col_ids[n, l]]``, masked; the table and ``vec``
    cast to ``dtype`` as in ``gather_history_extra``). The chunk width is
    ``WIDE_CHUNK``,
    halved until one chunk's gathered slab fits ``WIDE_SLAB_BYTES`` (a
    bucket with dim < width <= WIDE_CHUNK can be wide while one
    full-width chunk would gather the whole slab); the last chunk may be
    narrower."""
    n, l = bucket.n_rows, bucket.width
    w = min(WIDE_CHUNK, l)
    table = cast(table, dtype)
    d_aug = table.shape[1] + (0 if vec is None else 1)
    while w > 256 and n * w * d_aug * 4 > WIDE_SLAB_BYTES:
        w = (w + 1) // 2
    for off in range(0, l, w):
        cols = bucket.col_ids[:, off:off + w]
        pos = torch.arange(off, off + cols.shape[1],
                           device=bucket.length.device)
        mask = (pos[None, :] < bucket.length[:, None]).to(torch.float32)
        emb = table[cols] * mask[..., None].to(table.dtype)
        extra = None if vec is None else (
            vec[cols].to(table.dtype).to(torch.float32) * mask)
        yield emb, mask, extra


def wide_assemble(table: torch.Tensor, bucket: Bucket,
                  extra_vec: Optional[torch.Tensor] = None, dtype=None,
                  row_coef: Optional[torch.Tensor] = None,
                  init_a: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed ``(sum_h wt v v^T, sum_h wt v)`` over column chunks with
    ``wt = mask`` (or ``extra[col] * mask`` when ``extra_vec`` is given),
    times ``row_coef`` ([N]) when given; ``init_a`` ([N, d, d]) seeds the
    accumulator (the c1*G term), which is updated in place."""
    n, d = bucket.n_rows, table.shape[1]
    a = (torch.zeros((n, d, d), dtype=torch.float32, device=table.device)
         if init_a is None else init_a)
    rhs = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket, dtype):
        wt = mask if wt is None else wt
        if row_coef is not None:
            wt = wt * row_coef[:, None]
        a += row_gramians(emb, col_weight=wt)
        rhs += row_sums(emb, col_weight=wt)
    return a, rhs


def wide_matvec(table: torch.Tensor, bucket: Bucket, x: torch.Tensor,
                extra_vec: Optional[torch.Tensor] = None, dtype=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed ``(sum_h wt v (v.x), sum_h wt v)`` (the history terms of
    A @ x and rhs) for the gradient models."""
    n, d = bucket.n_rows, table.shape[1]
    ax = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    rhs = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket, dtype):
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x)
        ax += row_sums(emb, col_weight=wt * p)
        rhs += row_sums(emb, col_weight=wt)
    return ax, rhs


def wide_gram_resid(table: torch.Tensor, bucket: Bucket,
                    x_full: torch.Tensor,
                    extra_vec: Optional[torch.Tensor] = None, dtype=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed FULL normal-equation pieces for the blockwise models'
    zipf-head rows:

        S  = sum_h wt v v^T            [N, d, d]
        r0 = sum_h wt v (pred0 - 1)    [N, d],  pred0 = <v, x_full>

    with ``wt = mask`` (or ``extra[col] * mask``). Wide rows are few, so
    [N, d, d] fits while their [N, L, d] slab does not; every block
    system of the sweep is then a slice of (S, r0): pred is linear in x
    with the other side frozen, so ``sum_h wt v_loc (pred - 1) = r0_loc +
    (S @ (x - x0))_loc``. One streamed pass serves all d/bs block solves
    (``models/common.py::block_sweep_frozen`` consumes this)."""
    n, d = bucket.n_rows, table.shape[1]
    s_acc = torch.zeros((n, d, d), dtype=torch.float32, device=table.device)
    r0 = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket, dtype):
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x_full)
        s_acc += row_gramians(emb, col_weight=wt)
        r0 += row_sums(emb, col_weight=wt * (p - mask))
    return s_acc, r0


def wide_obs(table: torch.Tensor, bucket: Bucket,
             probe_rows: torch.Tensor, dtype=None) -> torch.Tensor:
    """Streamed per-row ``sum_h (v.u - 1)^2`` for the loss pass."""
    acc = torch.zeros((bucket.n_rows,), dtype=torch.float32,
                      device=table.device)
    for emb, mask, _ in wide_chunks(table, None, bucket, dtype):
        p = rowwise_dot(emb, probe_rows)
        acc += (torch.square(p - 1.0) * mask).sum(dim=1)
    return acc


def _window(bucket: Bucket, num_rows: int) -> slice:
    """The contiguous bucket's padded table window. ``_renumber_buckets``
    marks a bucket contiguous only when the window fits the table, so a
    plain slice is exact (JAX's dynamic_slice would clamp the start)."""
    lo, hi = bucket.row_start, bucket.row_start + bucket.n_rows
    if hi > num_rows:
        raise ValueError(f"contiguous bucket window [{lo}, {hi}) overruns "
                         f"a table of {num_rows} rows")
    return slice(lo, hi)


def read_rows(table: torch.Tensor, bucket: Bucket) -> torch.Tensor:
    """``table[bucket.row_ids]``: a slice for contiguous buckets, a
    gather with pad ids clamped (as JAX clamps) otherwise. Pad rows read
    rows that are not theirs; their solves are discarded on write-back."""
    if bucket.contiguous:
        return table[_window(bucket, table.shape[0])]
    return table[bucket.row_ids.clamp(max=table.shape[0] - 1)]


def scatter_bucket(table: torch.Tensor, bucket: Bucket,
                   values: torch.Tensor) -> torch.Tensor:
    """Write solved rows back IN PLACE; pad rows are left untouched
    (contiguous buckets keep the table's values under the [N] mask,
    others drop pad ids, whose positions cost one host read:
    ``host_sync.scatter``). Returns ``table``."""
    vals = values.to(table.dtype)
    if bucket.contiguous:
        win = _window(bucket, table.shape[0])
        mask = (bucket.length > 0).reshape((-1,) + (1,) * (table.dim() - 1))
        table[win] = torch.where(mask, vals, table[win])
        return table
    with span("host_sync.scatter"):
        keep = torch.nonzero(bucket.row_ids < table.shape[0])[:, 0]
    table[bucket.row_ids[keep]] = vals[keep]
    return table


# Per-row scalar write-back: the same masked in-place contract.
scatter_bucket_vector = scatter_bucket
