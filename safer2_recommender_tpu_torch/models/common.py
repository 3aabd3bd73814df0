"""Shared batched building blocks of the models (the counterpart of
``safer2_recommender_tpu/models/common.py``, direct-solve path).

Each function maps a whole padded bucket of users or items to new
embedding rows. Conventions:

  * ``table_other`` is the frozen side's embedding table (items when
    solving users and vice versa);
  * ``gram`` is the global Gramian of the frozen side (possibly
    dual-weighted), computed once per sweep;
  * returned row blocks are [N, ...]; pad rows produce values that the
    write-back discards.

The JAX package's XLA scheduling devices (``zero_token``,
``tie_bucket``, ``BucketStack`` scans) have no counterpart: PyTorch
runs the buckets in order, one after another.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from safer2_recommender_tpu_torch.data.dataset import Bucket
from safer2_recommender_tpu_torch.ops import assemble, solve
from safer2_recommender_tpu_torch.ops.woodbury import SolveParams


def safe_len(bucket: Bucket) -> torch.Tensor:
    """History sizes as f32 with padded rows clamped to 1 (avoids 0-div)."""
    return bucket.length.clamp(min=1).to(torch.float32)


def _solve_groups(buckets: Sequence[Bucket], dim: int,
                  budget_bytes: int = 2 << 30) -> List[List[int]]:
    """Greedily group bucket indices so one solve batch's live slabs,
    the [rows, d, d] systems and the gathered [rows, L, d] histories,
    stay under the memory budget."""
    def cost(b):
        return b.n_rows * (dim * dim * 4 + b.width * (dim + 1) * 4)

    cap = max(budget_bytes, 64 * dim * dim * 4)
    groups, cur, used = [], [], 0
    for i, b in enumerate(buckets):
        c = cost(b)
        if cur and used + c > cap:
            groups.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += c
    if cur:
        groups.append(cur)
    return groups


def assemble_from_params(p: SolveParams, gram: torch.Tensor):
    """Direct normal equations from the shared parameterization:

    A = c1*G + emb^T diag(wt) emb ;  rhs = emb^T r.

    The ridge c0*I is NOT added here: it rides the solver's lazy
    diagonal shift (``solve.solve(..., ridge=p.c0)``)."""
    a = assemble.row_gramians(p.emb, col_weight=p.wt)
    rhs = assemble.row_sums(p.emb, col_weight=p.r)
    a = a + p.c1[:, None, None] * gram[None].to(a.dtype)
    return a, rhs


def solve_sweep(table: torch.Tensor, buckets: Sequence[Bucket], params_fn,
                gram: torch.Tensor, *, use_cg: bool = False,
                pre_list=None) -> torch.Tensor:
    """One full ALS sweep over all buckets; returns a NEW table (the
    input is copied once, then updated in place bucket by bucket).

    ``params_fn(bucket, pre=None) -> SolveParams``; ``pre`` is the
    bucket's pre-gathered ``(emb, mask)`` from ``gather_and_losses``
    (one entry per bucket, or None), so the loss pass and the U-sweep
    share one gather of the frozen table. Buckets are concatenated into
    as few budget-capped solve batches as possible."""
    table = table.clone()
    if not buckets:
        return table
    if pre_list is None:
        pre_list = [None] * len(buckets)
    if len(pre_list) != len(buckets):
        raise ValueError(f"pre_list has {len(pre_list)} entries for "
                         f"{len(buckets)} buckets")
    for group in _solve_groups(buckets, table.shape[1]):
        ps = [params_fn(buckets[i], pre_list[i]) for i in group]
        systems = [assemble_from_params(p, gram) for p in ps]
        x = solve.solve(torch.cat([s[0] for s in systems]),
                        torch.cat([s[1] for s in systems]), use_cg=use_cg,
                        ridge=torch.cat([p.c0 for p in ps]))
        ofs = 0
        for i in group:
            b = buckets[i]
            assemble.scatter_bucket(table, b, x[ofs:ofs + b.n_rows])
            ofs += b.n_rows
    return table


def params_weighted_mean(table_other: torch.Tensor, bucket: Bucket,
                         reg_rows: torch.Tensor, uobs: float,
                         row_weight: torch.Tensor,
                         pre=None) -> SolveParams:
    """SAFER-family user-side system (reference safer2.h:104-163):

    A = w * (sum_h v v^T / |H| + uobs * G) + reg * I
    rhs = (w / |H|) * sum_h v
    """
    coef = row_weight / safe_len(bucket)          # w / |H|
    emb, mask = pre or assemble.gather_history(table_other, bucket)
    wt = coef[:, None] * mask
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows,
                       c1=row_weight * uobs)


def params_weighted_item(table_other: torch.Tensor, bucket: Bucket,
                         reg_rows: torch.Tensor, uobs: float,
                         norm_dual: torch.Tensor) -> SolveParams:
    """SAFER-family item-side system (reference safer2.h:166-221),
    against the dual-weighted Gramian U^T diag(z) U:

    A = uobs * G_w + reg * I + sum_h wt_u u u^T
    rhs = sum_h wt_u u            with wt_u = z_u / |H_u|.
    """
    c1 = torch.full((bucket.n_rows,), uobs, dtype=torch.float32,
                    device=table_other.device)
    emb, _, wt = assemble.gather_history_extra(table_other, norm_dual,
                                               bucket)
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows, c1=c1)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

# Keep the loss pass's gathered [N, L, d] slabs for the following
# U-sweep only when they all fit comfortably in device memory; above
# this the sweep gathers again.
FUSE_BUDGET_BYTES = 4 << 30


def user_losses(user_emb: torch.Tensor, item_emb: torch.Tensor,
                gramian: torch.Tensor, by_user, num_users: int, uobs: float,
                *, halve: bool) -> torch.Tensor:
    """Per-user losses (reference ials.h:70-86 / safer2.h:85-101):

    L_u = sum_h (v^T u - 1)^2 / |H_u| + uobs * u^T G u   [ / 2 if halve ]

    Absent users keep loss 0."""
    return gather_and_losses(item_emb, by_user, user_emb, gramian,
                             num_users, uobs, halve=halve,
                             budget_bytes=0)[0]


def gather_and_losses(table_other: torch.Tensor, buckets, probe_table,
                      gramian: torch.Tensor, num_rows: int, uobs: float, *,
                      halve: bool,
                      budget_bytes: int = FUSE_BUDGET_BYTES):
    """Per-row losses of the carried model, returning the gathered
    history slabs for ``solve_sweep(pre_list=...)`` so the U-sweep that
    follows reuses them (the models move the reference's end-of-epoch
    loss pass to the top of the next epoch, where it reads the same
    frozen tables the U-step does; see ``SAFER2._epoch``).

    Returns ``(loss [num_rows], pre_list or None)``, one ``pre`` entry
    per bucket."""
    dim = table_other.shape[1]
    total = sum(b.n_rows * b.width for b in buckets) * dim * 4
    keep = total <= budget_bytes
    out = torch.zeros((num_rows,), dtype=torch.float32,
                      device=table_other.device)
    pre = [] if keep else None
    for b in buckets:
        x = assemble.read_rows(probe_table, b)
        emb, mask = assemble.gather_history(table_other, b)
        p = assemble.rowwise_dot(emb, x)
        obs = (torch.square(p - 1.0) * mask).sum(dim=1) / safe_len(b)
        quad = uobs * ((x @ gramian) * x).sum(dim=1)
        loss = obs + quad
        if halve:
            loss = loss * 0.5
        assemble.scatter_bucket_vector(out, b, loss)
        if keep:
            pre.append((emb, mask))
    return out, pre


def normal_init(generator: torch.Generator, rows: int, dim: int,
                stdev: float, device) -> torch.Tensor:
    """N(0, stdev/sqrt(dim)) init (reference recommender.h:61-67 with the
    adjusted stdev of ials.h:47). The draws come from ``generator`` and
    differ from the JAX package's; ``interop.state_from_jax`` carries
    that package's tables across where the two must start equal."""
    return torch.randn((rows, dim), generator=generator, device=device,
                       dtype=torch.float32) * (stdev / (dim ** 0.5))
