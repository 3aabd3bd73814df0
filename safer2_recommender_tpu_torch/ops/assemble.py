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
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from safer2_recommender_tpu_torch.data.dataset import Bucket

WIDE_SLAB_BYTES = 768 << 20
WIDE_CHUNK = 4096


def is_wide(bucket: Bucket, dim: int) -> bool:
    """Stream this bucket through column chunks? Only when the *width*
    is the problem (width > dim keeps it off the Woodbury path; narrow
    slabs are bounded by build-time chunking)."""
    return bucket.width > dim and (
        bucket.n_rows * bucket.width * (dim + 1) * 4 > WIDE_SLAB_BYTES)


def history_mask(bucket: Bucket) -> torch.Tensor:
    """[N, L] float32 mask of valid (non-padding) history slots."""
    pos = torch.arange(bucket.width, device=bucket.length.device)
    return (pos[None, :] < bucket.length[:, None]).to(torch.float32)


def gather_history(table: torch.Tensor,
                   bucket: Bucket) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the other-side embedding rows for each history slot.
    Returns (emb [N, L, d] already masked, mask [N, L])."""
    mask = history_mask(bucket)
    emb = table[bucket.col_ids] * mask[..., None].to(table.dtype)
    return emb, mask


def gather_history_extra(table: torch.Tensor, vec: torch.Tensor,
                         bucket: Bucket
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row gather of the embedding rows and a per-row scalar: returns
    (emb [N, L, d] masked, mask [N, L], extra [N, L] f32 masked) with
    ``extra[n, l] = vec[col_ids[n, l]]``."""
    mask = history_mask(bucket)
    emb = table[bucket.col_ids] * mask[..., None].to(table.dtype)
    extra = vec[bucket.col_ids].to(torch.float32) * mask
    return emb, mask, extra


def row_gramians(emb: torch.Tensor,
                 col_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched sum of weighted outer products: [N, L, d] -> [N, d, d]."""
    lhs = emb if col_weight is None else emb * col_weight[..., None]
    return torch.bmm(lhs.transpose(1, 2), emb)


def row_sums(emb: torch.Tensor,
             col_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched weighted rhs accumulation: [N, L, d] -> [N, d]."""
    lhs = emb if col_weight is None else emb * col_weight[..., None]
    return lhs.sum(dim=1)


def rowwise_dot(emb: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Per-slot dots: [N, L, d] x [N, d] -> [N, L]."""
    return (emb * vec[:, None, :]).sum(dim=2)


# --------------------------------------------------------------------------
# Column-chunked ("wide") assembly for very long histories
# --------------------------------------------------------------------------


def wide_chunks(table: torch.Tensor, vec: Optional[torch.Tensor],
                 bucket: Bucket) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                                   Optional[torch.Tensor]]]:
    """Yield ``(emb [N, W, d] masked, mask [N, W], extra [N, W] or None)``
    for consecutive column chunks of ``bucket``, left to right
    (``extra[n, l] = vec[col_ids[n, l]]``, masked). The chunk width is
    ``WIDE_CHUNK``,
    halved until one chunk's gathered slab fits ``WIDE_SLAB_BYTES`` (a
    bucket with dim < width <= WIDE_CHUNK can be wide while one
    full-width chunk would gather the whole slab); the last chunk may be
    narrower."""
    n, l = bucket.n_rows, bucket.width
    w = min(WIDE_CHUNK, l)
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
            vec[cols].to(torch.float32) * mask)
        yield emb, mask, extra


def wide_assemble(table: torch.Tensor, bucket: Bucket,
                  extra_vec: Optional[torch.Tensor] = None,
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
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket):
        wt = mask if wt is None else wt
        if row_coef is not None:
            wt = wt * row_coef[:, None]
        a += row_gramians(emb, col_weight=wt)
        rhs += row_sums(emb, col_weight=wt)
    return a, rhs


def wide_matvec(table: torch.Tensor, bucket: Bucket, x: torch.Tensor,
                extra_vec: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streamed ``(sum_h wt v (v.x), sum_h wt v)`` (the history terms of
    A @ x and rhs) for the gradient models."""
    n, d = bucket.n_rows, table.shape[1]
    ax = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    rhs = torch.zeros((n, d), dtype=torch.float32, device=table.device)
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket):
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x)
        ax += row_sums(emb, col_weight=wt * p)
        rhs += row_sums(emb, col_weight=wt)
    return ax, rhs


def wide_gram_resid(table: torch.Tensor, bucket: Bucket,
                    x_full: torch.Tensor,
                    extra_vec: Optional[torch.Tensor] = None
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
    for emb, mask, wt in wide_chunks(table, extra_vec, bucket):
        wt = mask if wt is None else wt
        p = rowwise_dot(emb, x_full)
        s_acc += row_gramians(emb, col_weight=wt)
        r0 += row_sums(emb, col_weight=wt * (p - mask))
    return s_acc, r0


def wide_obs(table: torch.Tensor, bucket: Bucket,
             probe_rows: torch.Tensor) -> torch.Tensor:
    """Streamed per-row ``sum_h (v.u - 1)^2`` for the loss pass."""
    acc = torch.zeros((bucket.n_rows,), dtype=torch.float32,
                      device=table.device)
    for emb, mask, _ in wide_chunks(table, None, bucket):
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
    others drop pad ids). Returns ``table``."""
    vals = values.to(table.dtype)
    if bucket.contiguous:
        win = _window(bucket, table.shape[0])
        mask = (bucket.length > 0).reshape((-1,) + (1,) * (table.dim() - 1))
        table[win] = torch.where(mask, vals, table[win])
        return table
    keep = bucket.row_ids < table.shape[0]
    table[bucket.row_ids[keep]] = vals[keep]
    return table


# Per-row scalar write-back: the same masked in-place contract.
scatter_bucket_vector = scatter_bucket
