"""Normal-equation assembly over padded buckets (the counterpart of
``safer2_recommender_tpu/ops/assemble.py``, narrow path).

For a bucket of N rows whose histories are padded to L columns,

    A_hist[n] = sum_{l < len(n)} v_{n,l} v_{n,l}^T
             == einsum('nld,nle->nde', Vh, Vh)       (one batched matmul)

Pad rows carry the out-of-bounds id ``num_rows``: JAX drops writes to
it and clamps reads of it, torch raises, so every read or write here
masks or clamps pad rows first. Buckets whose gathered slab would not
fit in memory ("wide", zipf-head histories) stream through column
chunks in the JAX package; that path is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from safer2_recommender_tpu_torch.data.dataset import Bucket

WIDE_SLAB_BYTES = 768 << 20

WIDE_NOT_PORTED = (
    "a bucket's gathered history slab exceeds WIDE_SLAB_BYTES, which "
    "takes the column-chunked (wide) assembly in the JAX package; it is "
    "not ported to PyTorch yet (ROADMAP Queue 1 item 13)")


def is_wide(bucket: Bucket, dim: int) -> bool:
    """Would the JAX package stream this bucket through column chunks?
    Only when the *width* is the problem (width > dim keeps it off the
    Woodbury path; narrow slabs are bounded by build-time chunking)."""
    return bucket.width > dim and (
        bucket.n_rows * bucket.width * (dim + 1) * 4 > WIDE_SLAB_BYTES)


def _require_narrow(bucket: Bucket, dim: int) -> None:
    if is_wide(bucket, dim):
        raise NotImplementedError(WIDE_NOT_PORTED)


def history_mask(bucket: Bucket) -> torch.Tensor:
    """[N, L] float32 mask of valid (non-padding) history slots."""
    pos = torch.arange(bucket.width, device=bucket.length.device)
    return (pos[None, :] < bucket.length[:, None]).to(torch.float32)


def gather_history(table: torch.Tensor,
                   bucket: Bucket) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the other-side embedding rows for each history slot.
    Returns (emb [N, L, d] already masked, mask [N, L])."""
    _require_narrow(bucket, table.shape[1])
    mask = history_mask(bucket)
    emb = table[bucket.col_ids] * mask[..., None].to(table.dtype)
    return emb, mask


def gather_history_extra(table: torch.Tensor, vec: torch.Tensor,
                         bucket: Bucket
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row gather of the embedding rows and a per-row scalar: returns
    (emb [N, L, d] masked, mask [N, L], extra [N, L] f32 masked) with
    ``extra[n, l] = vec[col_ids[n, l]]``."""
    _require_narrow(bucket, table.shape[1])
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
