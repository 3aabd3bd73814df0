"""Shared batched building blocks of the six models (the counterpart
of ``safer2_recommender_tpu/models/common.py``: the exact solve sweeps,
the gradient steps' matvec form, the blockwise sweep of the ++ models
and the loss pass).

Each function maps a whole padded bucket of users or items to new
embedding rows. Conventions:

  * ``table_other`` is the frozen side's embedding table (items when
    solving users and vice versa);
  * ``gram`` is the global Gramian of the frozen side (possibly
    dual-weighted), computed once per sweep;
  * returned row blocks are [N, ...]; pad rows produce values that the
    write-back discards;
  * ``dtype`` (None or ``torch.bfloat16``, the model's ``asm_dtype``) is
    the history slabs' assembly dtype (``ops/assemble.py``); tables,
    Gramians, systems and solutions stay float32.

The JAX package's XLA scheduling devices (``zero_token``,
``tie_bucket``, ``BucketStack`` scans) have no counterpart: PyTorch
runs the buckets in order, one after another.

On a mesh (``Bucket.mesh``, a ``parallel/mesh.py::Mesh``) each rank
holds its block of every bucket's rows and a whole copy of each table.
A sweep solves the rank's rows into its copy, then ``share_rows`` hands
every rank the rows the others solved: one collective per sweep (per
block step in ``block_sweep_interleaved``, whose other side reads every
row's block). A self-side solve reads only its own rows, so nothing
else waits for it. Per-row losses travel the same way.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import torch

from safer2_recommender_tpu_torch.data.dataset import Bucket
from safer2_recommender_tpu_torch.ops import assemble, solve, woodbury
from safer2_recommender_tpu_torch.ops.woodbury import SolveParams
from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.utils.logging import span


def share_rows(table: torch.Tensor,
               buckets: Sequence[Bucket]) -> torch.Tensor:
    """Every rank's rows of ``buckets`` (its block of each) into every
    rank's copy of ``table`` ([rows, d] or [rows]), in place: one
    all-gather of the rows with their ids packed beside them as float32
    bits (the gather moves bytes, so they arrive exact). Padded rows
    (sentinel ids) never reach the table. Identity without a mesh (the
    buckets') or for buckets that are not ``shared``."""
    if not buckets or buckets[0].mesh is None or not buckets[0].shared:
        return table
    mesh = buckets[0].mesh
    n = table.shape[0]
    vals = torch.cat([assemble.read_rows(table, b) for b in buckets])
    ids = torch.cat([b.row_ids for b in buckets]).to(torch.int32)
    packed = torch.cat([vals.reshape(ids.shape[0], -1),
                        ids.view(torch.float32)[:, None]], dim=1)
    got = mesh_lib.all_gather_rows(mesh, packed)
    rows = got[:, -1].contiguous().view(torch.int32).to(torch.int64)
    keep = rows < n
    table[rows[keep]] = got[keep, :-1].reshape(
        (-1,) + tuple(table.shape[1:]))
    return table


def safe_len(bucket: Bucket) -> torch.Tensor:
    """History sizes as f32 with padded rows clamped to 1 (avoids 0-div)."""
    return bucket.length.clamp(min=1).to(torch.float32)


def _solve_groups(buckets: Sequence[Bucket], dim: int,
                  budget_bytes: int = 2 << 30) -> List[List[int]]:
    """Greedily group bucket indices so one solve batch's live slabs,
    the [rows, d, d] systems and the gathered [rows, L, d] histories,
    stay under the memory budget. A wide bucket gathers one column chunk
    at a time, so it is costed at ``min(width, WIDE_CHUNK)`` columns. A
    sharded bucket is costed whole (``Bucket.global_rows``): the batches,
    and so the rows solved in the rotated basis, are the one-device
    run's, as in the JAX package."""
    def cost(b):
        w_eff = min(b.width, assemble.WIDE_CHUNK) if (
            assemble.is_wide(b, dim)) else b.width
        return b.global_rows * (dim * dim * 4 + w_eff * (dim + 1) * 4)

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


def _direct_groups(buckets: Sequence[Bucket], dim: int) -> List[List[int]]:
    """The direct solve batches of the JAX package's ``solve_sweep``:
    buckets that share their (rows, width, contiguity) with another run
    there as one scan, one bucket per solve, so each is a batch of its
    own here; the rest are cut by ``_solve_groups``. The batching
    decides which rows are solved in the rotated basis (a batch holding
    a wide bucket is not), so it is kept exactly."""
    key = [(b.n_rows, b.width, b.contiguous) for b in buckets]
    count = Counter(key)
    alone = [[i] for i, k in enumerate(key) if count[k] > 1]
    singles = [i for i, k in enumerate(key) if count[k] == 1]
    return alone + [[singles[j] for j in g] for g in
                    _solve_groups([buckets[i] for i in singles], dim)]


def rotate_table(table: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``table @ q`` in the table's dtype (``assemble.matmul_lowp``): row
    for row the product a gathered slab of it would take, so a slab
    gathered from the result is the rotated slab."""
    with span("sweep.rotate_table", rows=table.shape[0]):
        return assemble.matmul_lowp(table, q)


def rotated_items(eig, item_emb: torch.Tensor,
                  dtype) -> Optional[torch.Tensor]:
    """A fold-in's frozen item table cast to ``dtype`` and rotated into
    ``eig``'s basis (``rotate_table``), or None without ``eig``: state
    alone, so computed once a state (``Recommender._fold_in_prep``)."""
    if eig is None:
        return None
    return rotate_table(assemble.cast(item_emb, dtype), eig[0])


def assemble_rotated(p: SolveParams, eig) -> Tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """Direct normal equations in the shared Gramian's eigenbasis.

    With G = Q diag(lam) Q^T (the decomposition the Woodbury path
    computes once per sweep), rotating the gathered histories once
    (E_rot = E @ Q) makes the c1*G term diagonal:

        Q^T A Q = (E_rot)^T diag(wt) E_rot + diag(c0 + c1*lam)

    so it rides the solver's lazy diagonal shift as a [N, d] ridge
    instead of a broadcast add over the [N, d, d] systems. Solve the
    rotated system, then rotate the solution back: x = y @ Q^T. Here
    from the plain slab, rotated in its dtype; the sweeps gather E_rot
    from the rotated table and call ``assemble_in_basis``.

    Returns (a_rot, rhs_rot, ridge [N, d]).
    """
    q, lam = eig
    return assemble_in_basis(
        p._replace(emb=assemble.matmul_lowp(p.emb, q)), lam)


def assemble_in_basis(p: SolveParams, lam: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``assemble_rotated`` with ``p.emb`` = E_rot already."""
    a = assemble.row_gramians(p.emb, col_weight=p.wt)
    rhs = assemble.row_sums(p.emb, col_weight=p.r)
    ridge = p.c0[:, None] + p.c1[:, None] * lam[None, :]
    return a, rhs, ridge


def assemble_from_params(p: SolveParams, gram: torch.Tensor):
    """Direct normal equations from the shared parameterization:

    A = c1*G + emb^T diag(wt) emb ;  rhs = emb^T r.

    The ridge c0*I is NOT added here: it rides the solver's lazy
    diagonal shift (``solve.solve(..., ridge=p.c0)``). On the wide
    (column-chunked) path the c1*G term seeds the streaming accumulator
    and the row coefficient folds into the chunk weights."""
    if p.wide is not None:
        wh = p.wide
        init_a = p.c1[:, None, None] * gram[None]
        return assemble.wide_assemble(wh.table, wh.bucket,
                                      extra_vec=wh.extra_vec,
                                      row_coef=wh.row_coef, init_a=init_a)
    a = assemble.row_gramians(p.emb, col_weight=p.wt)
    rhs = assemble.row_sums(p.emb, col_weight=p.r)
    a = a + p.c1[:, None, None] * gram[None].to(a.dtype)
    return a, rhs


def grad_from_params(p: SolveParams, gram: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """A @ x - rhs via matvecs (no [N, d, d] materialization): the
    CVaR-MF subgradient (reference cvar_mf.h:133, :179). A streamed
    (wide) bucket's rows are counted in ``woodbury.SOLVE_PATHS``."""
    ax0 = p.c0[:, None] * x + p.c1[:, None] * (x @ gram)
    if p.wide is not None:
        wh = p.wide
        ax_h, rhs = assemble.wide_matvec(wh.table, wh.bucket, x,
                                         extra_vec=wh.extra_vec)
        if wh.row_coef is not None:
            ax_h = ax_h * wh.row_coef[:, None]
            rhs = rhs * wh.row_coef[:, None]
        woodbury.SOLVE_PATHS["wide"] += wh.bucket.n_rows
        return ax0 + ax_h - rhs
    vx = assemble.rowwise_dot(p.emb, x)
    ax = ax0 + assemble.row_sums(p.emb, col_weight=p.wt * vx)
    return ax - assemble.row_sums(p.emb, col_weight=p.r)


def solve_sweep(table: torch.Tensor, buckets: Sequence[Bucket], params_fn,
                gram: torch.Tensor, *, table_other: torch.Tensor, eig=None,
                t_rot: Optional[torch.Tensor] = None, use_cg: bool = False,
                cg_tol: float = 1e-10, cg_iters: int = 100,
                pre_list=None) -> torch.Tensor:
    """One full ALS sweep over all buckets; returns a NEW table (the
    input is copied once, then updated in place bucket by bucket).

    ``params_fn(bucket, pre, other) -> SolveParams`` gathers the
    bucket's history from ``other``: ``table_other``, the frozen table
    in the assembly dtype, or its rotation ``t_rot`` for the buckets
    solved in the eigenbasis. ``pre`` is the bucket's pre-gathered
    ``(emb, mask)`` from ``gather_and_losses`` (one entry per bucket,
    or None), so the loss pass and the U-sweep share one gather of the
    frozen table where the slab is solved as gathered.

    With ``eig`` (the shared Gramian's eigendecomposition), buckets whose
    history width is at most dim/2 take the Woodbury path (an L x L
    solve per row), and the direct d x d systems are assembled and
    solved in the eigenbasis, except in a batch that holds a wide
    bucket (``_direct_groups``). Those buckets gather their slabs
    already rotated from ``t_rot = rotate_table(table_other, Q)``
    (None rotates it here, once a sweep). Without ``eig`` every bucket
    is solved directly. ``use_cg`` solves the direct systems by batched
    conjugate gradient (``solve.cg_solve`` with ``cg_tol`` /
    ``cg_iters``), never rotated. ``woodbury.SOLVE_PATHS`` counts the
    rows of each path. On a mesh the ranks' rows are shared at the end
    (``share_rows``)."""
    table = table.clone()
    if not buckets:
        return table
    if pre_list is None:
        pre_list = [None] * len(buckets)
    if len(pre_list) != len(buckets):
        raise ValueError(f"pre_list has {len(pre_list)} entries for "
                         f"{len(buckets)} buckets")
    dim = table.shape[1]
    paths = woodbury.SOLVE_PATHS
    wood = [eig is not None and woodbury.applicable(b.width, dim)
            for b in buckets]
    direct = [i for i, w in enumerate(wood) if not w]
    rotate = eig is not None and not use_cg
    groups = [[direct[j] for j in g]
              for g in _direct_groups([buckets[i] for i in direct], dim)]
    g_rots = [rotate and not any(assemble.is_wide(buckets[i], dim)
                                 for i in g) for g in groups]
    if t_rot is None and (any(wood) or any(g_rots)):
        t_rot = rotate_table(table_other, eig[0])

    def params(i: int, in_basis: bool) -> SolveParams:
        if in_basis:
            paths["table_rotated"] += buckets[i].n_rows
            return params_fn(buckets[i], None, t_rot)
        return params_fn(buckets[i], pre_list[i], table_other)

    for i, b in enumerate(buckets):
        if not wood[i]:
            continue
        with span("sweep.woodbury"):
            x = woodbury.solve_in_basis(params(i, True), *eig)
            assemble.scatter_bucket(table, b, x)
        paths["woodbury"] += b.n_rows

    for group, g_rot in zip(groups, g_rots):
        with span("sweep.direct"):
            a, rhs, ridge = [], [], []
            for i in group:
                p = params(i, g_rot)
                if g_rot:
                    s = assemble_in_basis(p, eig[1])
                else:
                    s = assemble_from_params(p, gram) + (p.c0,)
                del p
                a.append(s[0])
                rhs.append(s[1])
                ridge.append(s[2])
            x = solve.solve(torch.cat(a), torch.cat(rhs), use_cg=use_cg,
                            tol=cg_tol, max_iters=cg_iters,
                            ridge=torch.cat(ridge))
            del a, rhs, ridge
            if g_rot:
                x = x @ eig[0].T
            ofs = 0
            for i in group:
                b = buckets[i]
                assemble.scatter_bucket(table, b, x[ofs:ofs + b.n_rows])
                ofs += b.n_rows
                paths["rotated" if g_rot else "direct"] += b.n_rows
                paths["wide"] += b.n_rows if assemble.is_wide(b, dim) else 0
    return share_rows(table, buckets)


def sweep_apply(buckets: Sequence[Bucket], pre_list, carry, body):
    """``body(carry, bucket, pre) -> carry`` over the buckets in order;
    ``pre_list`` holds one entry per bucket, or is None. A ``carry``
    that is a table of the buckets' rows is shared on a mesh by the
    caller (``share_rows``)."""
    if pre_list is None:
        pre_list = [None] * len(buckets)
    if len(pre_list) != len(buckets):
        raise ValueError(f"pre_list has {len(pre_list)} entries for "
                         f"{len(buckets)} buckets")
    for b, pre in zip(buckets, pre_list):
        carry = body(carry, b, pre)
    return carry


def _wide_hist(table_other, bucket, dtype, row_coef=None, extra_vec=None):
    return woodbury.WideHist(table=assemble.cast(table_other, dtype),
                             bucket=bucket, row_coef=row_coef,
                             extra_vec=extra_vec)


def params_ials(table_other: torch.Tensor, bucket: Bucket,
                reg_rows: torch.Tensor, uobs: float, dtype=None,
                pre=None) -> SolveParams:
    """iALS normal equations (reference ials.h:88-144):

    A = uobs * G + reg * I + sum_h v v^T ;  rhs = sum_h v.
    """
    c1 = torch.full((bucket.n_rows,), uobs, dtype=torch.float32,
                    device=table_other.device)
    if pre is None and assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows, c1=c1,
                           wide=_wide_hist(table_other, bucket, dtype))
    emb, mask = pre or assemble.gather_history(table_other, bucket, dtype)
    return SolveParams(emb=emb, wt=mask, r=mask, c0=reg_rows, c1=c1)


def params_weighted_mean(table_other: torch.Tensor, bucket: Bucket,
                         reg_rows: torch.Tensor, uobs: float,
                         row_weight: torch.Tensor, dtype=None,
                         pre=None) -> SolveParams:
    """SAFER-family user-side system (reference safer2.h:104-163,
    erm_mf.h:91-151):

    A = w * (sum_h v v^T / |H| + uobs * G) + reg * I
    rhs = (w / |H|) * sum_h v
    """
    coef = row_weight / safe_len(bucket)          # w / |H|
    if pre is None and assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows,
                           c1=row_weight * uobs,
                           wide=_wide_hist(table_other, bucket, dtype,
                                           row_coef=coef))
    emb, mask = pre or assemble.gather_history(table_other, bucket, dtype)
    wt = coef[:, None] * mask
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows,
                       c1=row_weight * uobs)


def params_weighted_item(table_other: torch.Tensor, bucket: Bucket,
                         reg_rows: torch.Tensor, uobs: float,
                         norm_dual: torch.Tensor, dtype=None) -> SolveParams:
    """SAFER-family item-side system (reference safer2.h:166-221,
    erm_mf.h:153-210), against the dual-weighted Gramian U^T diag(z) U:

    A = uobs * G_w + reg * I + sum_h wt_u u u^T
    rhs = sum_h wt_u u            with wt_u = z_u / |H_u|.
    """
    c1 = torch.full((bucket.n_rows,), uobs, dtype=torch.float32,
                    device=table_other.device)
    if assemble.is_wide(bucket, table_other.shape[1]):
        return SolveParams(emb=None, wt=None, r=None, c0=reg_rows, c1=c1,
                           wide=_wide_hist(table_other, bucket, dtype,
                                           extra_vec=norm_dual))
    emb, _, wt = assemble.gather_history_extra(table_other, norm_dual,
                                               bucket, dtype)
    return SolveParams(emb=emb, wt=wt, r=wt, c0=reg_rows, c1=c1)


# --------------------------------------------------------------------------
# Blockwise (subspace) solves with the per-slot prediction cache
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Per-row coefficients of one bucket's block delta systems:

        A   = ch * (sum_h wt v_loc v_loc^T) + cg * G_loc + reg * I
        rhs = ch * (sum_h wt v_loc (pred-1)) + cg * (G_lg @ x_full)
              + reg * x_loc
        x_loc <- x_loc - A^-1 rhs

    One parameterization covers all three reference variants:
    iALS++ (ialspp.h:85-145): ch=1, cg=uobs, wt=mask;
    SAFER2++ user (safer2pp.h:97-159): ch=w/|H|, cg=w*uobs, wt=mask;
    SAFER2++ item (safer2pp.h:161-216): ch=1, cg=uobs, wt=z/|H| per slot.
    ``reg`` rides the solver's lazy diagonal shift, never a slab add.
    """

    cg: torch.Tensor                    # [N] coefficient of the frozen Gramian
    reg: torch.Tensor                   # [N] ridge
    ch: Optional[torch.Tensor] = None   # [N] history coefficient (None = 1)


def block_eigh(gram: torch.Tensor, bs: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lam [nb, bs] clamped at 0, Q [nb, bs, bs]) of the Gramian's
    diagonal bs-blocks by one batched eigh: the shared ingredients of the
    block-level Woodbury solves of ``block_sweep_frozen``."""
    nb = gram.shape[0] // bs
    idx = torch.arange(nb, device=gram.device)
    diag = gram.reshape(nb, bs, nb, bs)[idx, :, idx, :]      # [nb, bs, bs]
    lam, q = woodbury.sym_eigh(diag)
    return lam.clamp(min=0.0), q


def block_sweep_frozen(table_self: torch.Tensor, table_other: torch.Tensor,
                       buckets: Sequence[Bucket], gram: torch.Tensor,
                       spec_fn, *, bs: int, n_sweeps: int = 1, dtype=None,
                       extra_vec: Optional[torch.Tensor] = None, eig=None,
                       block_eig=None, pre_list=None,
                       t_rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blockwise coordinate sweep(s) of one side against the FROZEN other
    side, the ++ models' hot loop; returns a NEW table.

    Bucket-outer, block-inner: each bucket gathers its [N, L, d] history
    slab once and every block (of every sweep, for the fold-in's
    ``n_sweeps``) slices it, with per-slot predictions maintained
    incrementally: the slab-local form of the reference's flat prediction
    cache (ialspp.h:399-406, safer2pp.h:504-508). The predictions are
    recomputed from the live tables at each call, so no drift carries
    over.

    Ordering: the reference interleaves StepU(block)/StepV(block)
    (ialspp.h:220-239, safer2pp.h:303-319); freezing the other side runs
    all blocks of U, then all blocks of V: the same per-block systems
    against the sweep-start other table (block-Jacobi across sides,
    Gauss-Seidel within a side).

    ``gram`` is the FULL Gramian of ``table_other`` (dual-weighted for
    the SAFER2++ item sweep): each block's G_loc / G_lg is a slice of it.
    ``spec_fn(bucket) -> BlockSpec`` supplies the per-row coefficients;
    ``extra_vec`` routes a per-column weight (the item sweep's z/|H|)
    through the slab gather; ``table_other`` is cast to ``dtype`` once
    for every gather. Three routes per bucket:

      * wide (``assemble.is_wide``): one streamed pass builds the full
        normal-equation pieces (``assemble.wide_gram_resid``) and every
        block solves from slices of them;
      * with ``eig = (Q, lam)`` of ``gram`` (``woodbury.maybe_eigh``), a
        bucket with ``2 * width <= dim`` runs ONE full-dim block through
        the full-dim Woodbury (``woodbury.solve_rhs``): the full-dim
        delta solve is the direct normal-equation solve (rhs = A x - b,
        so x - A^-1 rhs = A^-1 b), exact in one sweep, so further sweeps
        against the same frozen side would change nothing. These
        buckets gather their slabs already rotated from ``t_rot =
        rotate_table(table_other, Q)`` (None rotates it here, once a
        sweep), and a float32 rhs is summed from them, the slab K is
        built from (a plain sum, rotated, differs from it by rounding
        that the solve amplifies where the Gramian lacks rank); a
        bfloat16 rhs is summed from the bfloat16 slab and rotated in
        float32, as the JAX package does, since a rotated bfloat16 row
        is rounded once more;
      * otherwise ``n_sweeps`` passes over the bs-blocks (the last block
        is narrower when ``dim % bs != 0``). Without ``eig``, with
        ``dim % bs == 0`` and ``bs >= 16``, a bucket with
        ``2 * width <= bs`` solves each block through the block-level
        Woodbury: one batched eigh of the Gramian's diagonal blocks,
        shared by every row, and an L x L capacitance solve per row
        (``block_eig``, from ``block_eigh``; None computes it here).

    Every bs x bs (and L x L) system goes through ``solve.solve`` /
    ``block_chol.spd_solve``, so through the inverse-Cholesky kernel: a
    sweep launches it ``dim / bs`` times per bucket. ``emb[:, :, s:s+bs]``
    is a strided view of the slab; ``torch.bmm`` may copy it. On a
    mesh the ranks' rows are shared at the end (``share_rows``).
    """
    table = table_self.clone()
    if not buckets:
        return table
    if pre_list is not None and extra_vec is not None:
        raise ValueError("pre-gathered slabs carry no extra_vec column")
    dim = table.shape[1]
    paths = woodbury.SOLVE_PATHS
    q_full, lam_full = eig if eig is not None else (None, None)
    table_other = assemble.cast(table_other, dtype)

    wood = (q_full is None    # the full-dim Woodbury supersedes it
            and dim % bs == 0 and bs >= 16
            and any(not assemble.is_wide(b, dim) and 2 * b.width <= bs
                    for b in buckets))
    if wood:
        lam_all, q_all = (block_eig if block_eig is not None
                          else block_eigh(gram, bs))
    if t_rot is None and q_full is not None and any(
            woodbury.applicable(b.width, dim) for b in buckets):
        t_rot = rotate_table(table_other, q_full)

    def run_blocks(blk) -> None:
        for _ in range(n_sweeps):
            for s in range(0, dim, bs):
                blk(s, min(s + bs, dim))

    def do_full_woodbury(b: Bucket, pre, spec: BlockSpec) -> torch.Tensor:
        wt = (assemble.history_mask(b) if extra_vec is None else
              assemble.history_extra(extra_vec, b, table_other.dtype))

        def rhs_of(slab):
            rhs = assemble.row_sums(slab, col_weight=wt)
            return rhs if spec.ch is None else rhs * spec.ch[:, None]

        # the rotated slab, unmasked: it enters only through the
        # weights, 0 on padded slots
        w = t_rot[b.col_ids]
        if w.dtype == torch.float32:
            b_rot = rhs_of(w)
        else:
            b_rot = rhs_of(pre[0] if pre is not None else
                           assemble.gather_history(table_other, b)[0]
                           ) @ q_full
        if spec.ch is not None:
            wt = wt * spec.ch[:, None]
        paths["woodbury"] += b.n_rows
        paths["table_rotated"] += b.n_rows
        return woodbury.solve_rhs_in_basis(w, wt, spec.reg, spec.cg, b_rot,
                                           q_full, lam_full)

    def do_narrow(tbl, b: Bucket, pre) -> torch.Tensor:
        spec = spec_fn(b)
        if q_full is not None and woodbury.applicable(b.width, dim):
            return do_full_woodbury(b, pre, spec)
        if pre is not None:
            emb, mask, wt = pre[0], pre[1], None
        elif extra_vec is None:
            emb, mask = assemble.gather_history(table_other, b)
            wt = None
        else:
            emb, mask, wt = assemble.gather_history_extra(table_other,
                                                          extra_vec, b)
        wt_eff = mask if wt is None else wt
        if spec.ch is not None:
            wt_eff = wt_eff * spec.ch[:, None]

        xf = assemble.read_rows(tbl, b).clone()
        pred = assemble.rowwise_dot(emb, xf)
        use_wood = wood and 2 * b.width <= bs
        paths["block_woodbury" if use_wood else "block"] += b.n_rows

        def blk(s: int, e: int) -> None:
            nonlocal pred
            emb_loc = emb[:, :, s:e]
            x_loc = xf[:, s:e]
            resid = pred - mask
            rhs = assemble.row_sums(
                emb_loc, col_weight=resid if wt is None else wt * resid)
            if spec.ch is not None:
                rhs = rhs * spec.ch[:, None]
            rhs = (rhs + spec.cg[:, None] * (xf @ gram[s:e].T)
                   + spec.reg[:, None] * x_loc)
            if use_wood:
                k_i = s // bs
                delta = -woodbury.solve_rhs(emb_loc, wt_eff, spec.reg,
                                            spec.cg, rhs, q_all[k_i],
                                            lam_all[k_i])
            else:
                a = assemble.row_gramians(emb_loc, col_weight=wt)
                if spec.ch is not None:
                    a = a * spec.ch[:, None, None]
                a = a + spec.cg[:, None, None] * gram[s:e, s:e][None]
                delta = -solve.solve(a, rhs, ridge=spec.reg)
            pred = pred + (emb_loc * delta[:, None, :]).sum(dim=2)
            xf[:, s:e] = x_loc + delta

        run_blocks(blk)
        return xf

    def do_wide(tbl, b: Bucket) -> torch.Tensor:
        spec = spec_fn(b)
        xf0 = assemble.read_rows(tbl, b).clone()
        s_full, r0 = assemble.wide_gram_resid(table_other, b, xf0,
                                              extra_vec=extra_vec)
        xf = xf0.clone()
        paths["block"] += b.n_rows
        paths["wide"] += b.n_rows

        def blk(s: int, e: int) -> None:
            x_loc = xf[:, s:e]
            # pred is linear in xf: hist term = r0_loc + (S (xf - xf0))_loc
            rhs = r0[:, s:e] + torch.bmm(
                s_full[:, s:e, :], (xf - xf0)[:, :, None])[:, :, 0]
            a = s_full[:, s:e, s:e]
            if spec.ch is not None:
                a = a * spec.ch[:, None, None]
                rhs = rhs * spec.ch[:, None]
            a = a + spec.cg[:, None, None] * gram[s:e, s:e][None]
            rhs = (rhs + spec.cg[:, None] * (xf @ gram[s:e].T)
                   + spec.reg[:, None] * x_loc)
            xf[:, s:e] = x_loc - solve.solve(a, rhs, ridge=spec.reg)

        run_blocks(blk)
        return xf

    def do_bucket(tbl, b, pre):
        with span("sweep.block"):
            x = (do_wide(tbl, b) if assemble.is_wide(b, dim)
                 else do_narrow(tbl, b, pre))
            return assemble.scatter_bucket(tbl, b, x)

    return share_rows(sweep_apply(buckets, pre_list, table, do_bucket),
                      buckets)


# --------------------------------------------------------------------------
# Interleaved (reference-order) blockwise sweep
# --------------------------------------------------------------------------


def _column_offsets(chunks):
    """``(column offset, chunk)`` for each ``(emb, mask, extra)`` chunk
    of ``assemble.wide_chunks``, left to right."""
    off = 0
    for c in chunks:
        yield off, c
        off += c[1].shape[1]


def block_sweep_interleaved(u: torch.Tensor, v: torch.Tensor,
                            by_user: Sequence[Bucket],
                            by_item: Sequence[Bucket], spec_u_fn, spec_v_fn,
                            *, bs: int, dtype=None,
                            extra_vec_v: Optional[torch.Tensor] = None,
                            g_weight_v: Optional[torch.Tensor] = None):
    """Reference-order blockwise epoch: for each block s, StepU(s) then
    StepV(s) (ialspp.h:208-261, safer2pp.h:303-319), the trajectory
    ``block_sweep_frozen`` reorders. Returns NEW ``(u, v, preds_u)``.

    Each U block sees the same pd iteration's earlier V blocks and vice
    versa, and each block's local and local-global Gramians come from
    the LIVE other table (ialspp.h:362-365, safer2pp.h:532-544): G_lg =
    O_blk^T O ([bs, dim]), computed once per side step, with O_blk
    weighted row-wise by ``g_weight_v`` on the V side (U^T diag(z) U).
    The reference's flat per-tuple prediction cache (ialspp.h:399-406)
    becomes per-slot predictions carried in both adjacency views, one
    [N, L] tensor per bucket: a side step advances its own view's by the
    solved deltas, and ``propagate`` advances the other view's through
    the [rows, bs] delta table (pred[n, l] += delta[col[n, l]] .
    x[row, s:s+bs]), the cross-view half of the cache update.

    ``spec_*_fn(bucket) -> BlockSpec`` as in ``block_sweep_frozen``;
    ``extra_vec_v`` is the item sweep's per-user slot weight z/|H_u|.
    The [rows, bs] block of the other table that the slabs gather from
    is cast to ``dtype``; the live Gramians, the carried predictions and
    the delta table stay f32 (the increments compound).
    Every block solve goes through ``solve.solve`` (so the kernel at
    r = bs), one launch per bucket per block per side. Zipf-head buckets
    (``assemble.is_wide``) never gather an [N, L, bs] slab: their block
    gathers stream through column chunks (``assemble.wide_chunks``).
    Requires
    ``dim % bs == 0`` (the models fall back to the frozen sweep
    otherwise). ``preds_u`` aligns with ``by_user`` and feeds
    ``losses_from_preds``. ``woodbury.SOLVE_PATHS`` counts each bucket's
    rows once per call under ``block`` (and ``wide``). A side step
    scatters its deltas into the [rows, bs] delta table, shares them on a
    mesh (``share_rows``, one collective per side step) and then adds
    the table to its block of ``tbl_self``: the ranks' copies stay equal
    and the other view's predictions see every row's delta."""
    dim = u.shape[1]
    if dim % bs:
        raise ValueError(f"interleaved sweep needs dim % bs == 0, got "
                         f"dim {dim}, bs {bs}")
    u, v = u.clone(), v.clone()
    paths = woodbury.SOLVE_PATHS

    def pred_bucket(b: Bucket, tbl_self, other) -> torch.Tensor:
        """Fresh per-slot predictions, accumulated block by block, so no
        [N, L, dim] slab is built. Counts the bucket's rows once."""
        x_full = assemble.read_rows(tbl_self, b)
        pred = torch.zeros((b.n_rows, b.width), dtype=torch.float32,
                           device=u.device)
        wide = assemble.is_wide(b, dim)
        paths["block"] += b.n_rows
        paths["wide"] += b.n_rows if wide else 0
        for s in range(0, dim, bs):
            o_blk = assemble.cast(other[:, s:s + bs], dtype)
            x_loc = x_full[:, s:s + bs]
            if not wide:
                pred += assemble.rowwise_dot(
                    assemble.gather_history(o_blk, b)[0], x_loc)
                continue
            for off, (emb, _, _) in _column_offsets(
                    assemble.wide_chunks(o_blk, None, b)):
                pred[:, off:off + emb.shape[1]] += assemble.rowwise_dot(
                    emb, x_loc)
        return pred

    def side_step(tbl_self, other, s, buckets, preds, spec_fn, extra,
                  g_weight) -> torch.Tensor:
        """StepU / StepV at block offset ``s`` (ialspp.h:85-145,
        safer2pp.h:97-216): delta solves against the live Gramians.
        Updates ``tbl_self`` and ``preds`` in place; returns the
        [rows, bs] delta table (0 on rows of no bucket)."""
        o_blk = other[:, s:s + bs]
        lhs = o_blk if g_weight is None else o_blk * g_weight[:, None]
        g_lg = lhs.T @ other                       # [bs, dim], live
        g_loc = g_lg[:, s:s + bs]
        o_blk = assemble.cast(o_blk, dtype)
        dacc = torch.zeros((tbl_self.shape[0], bs), dtype=torch.float32,
                           device=tbl_self.device)

        def finish(spec, rhs, a, x_full, x_loc) -> torch.Tensor:
            if spec.ch is not None:
                rhs = rhs * spec.ch[:, None]
                a = a * spec.ch[:, None, None]
            rhs = (rhs + spec.cg[:, None] * (x_full @ g_lg.T)
                   + spec.reg[:, None] * x_loc)
            a = a + spec.cg[:, None, None] * g_loc[None]
            return -solve.solve(a, rhs, ridge=spec.reg)

        for b, pred in zip(buckets, preds):
            spec = spec_fn(b)
            x_full = assemble.read_rows(tbl_self, b)
            x_loc = x_full[:, s:s + bs]
            if assemble.is_wide(b, dim):
                # two streamed passes: accumulate the block system, then
                # advance the carried predictions by the solved delta
                a = torch.zeros((b.n_rows, bs, bs), dtype=torch.float32,
                                device=u.device)
                rhs = torch.zeros((b.n_rows, bs), dtype=torch.float32,
                                  device=u.device)
                for off, (emb, mask, wt) in _column_offsets(
                        assemble.wide_chunks(o_blk, extra, b)):
                    resid = pred[:, off:off + mask.shape[1]] - mask
                    rhs += assemble.row_sums(
                        emb, col_weight=resid if wt is None else wt * resid)
                    a += assemble.row_gramians(emb, col_weight=wt)
                delta = finish(spec, rhs, a, x_full, x_loc)
                for off, (emb, _, _) in _column_offsets(
                        assemble.wide_chunks(o_blk, None, b)):
                    pred[:, off:off + emb.shape[1]] += assemble.rowwise_dot(
                        emb, delta)
            else:
                if extra is None:
                    emb, mask = assemble.gather_history(o_blk, b)
                    wt = None
                else:
                    emb, mask, wt = assemble.gather_history_extra(
                        o_blk, extra, b)
                resid = pred - mask
                delta = finish(
                    spec,
                    assemble.row_sums(
                        emb, col_weight=resid if wt is None else wt * resid),
                    assemble.row_gramians(emb, col_weight=wt),
                    x_full, x_loc)
                pred += assemble.rowwise_dot(emb, delta)
            assemble.scatter_bucket(dacc, b, delta)
        # a bucket reads only its own rows of tbl_self, so the block is
        # updated once, after every bucket: old + delta, as a write-back
        # of x_loc + delta would give, and old + 0 elsewhere
        tbl_self[:, s:s + bs] += share_rows(dacc, buckets)
        return dacc

    def propagate(buckets, preds, dacc, tbl_self, s) -> None:
        """Fold the other side's block deltas into this view's carried
        predictions, in place; f32 throughout (the increments
        compound)."""
        x_blk = tbl_self[:, s:s + bs]
        for b, pred in zip(buckets, preds):
            xb = assemble.read_rows(x_blk, b)
            if not assemble.is_wide(b, dim):
                pred += assemble.rowwise_dot(
                    assemble.gather_history(dacc, b)[0], xb)
                continue
            for off, (dg, _, _) in _column_offsets(
                    assemble.wide_chunks(dacc, None, b)):
                pred[:, off:off + dg.shape[1]] += assemble.rowwise_dot(dg, xb)

    preds_u = [pred_bucket(b, u, v) for b in by_user]
    preds_i = [pred_bucket(b, v, u) for b in by_item]
    for s in range(0, dim, bs):
        du = side_step(u, v, s, by_user, preds_u, spec_u_fn, None, None)
        propagate(by_item, preds_i, du, v, s)
        dv = side_step(v, u, s, by_item, preds_i, spec_v_fn, extra_vec_v,
                       g_weight_v)
        propagate(by_user, preds_u, dv, u, s)
    return u, v, preds_u


def losses_from_preds(preds_u, by_user: Sequence[Bucket], u: torch.Tensor,
                      gram: torch.Tensor, num_users: int, uobs: float, *,
                      mean: bool, halve: bool) -> torch.Tensor:
    """Per-user losses from the carried per-slot predictions of
    ``block_sweep_interleaved``, the counterpart of the reference's
    cache-based ComputeUserLoss (safer2pp.h:611-652):
    sum_h (pred - 1)^2 [/ |H| if mean] + uobs * u^T G u [x 0.5 if
    halve]. Absent users keep loss 0. Shared on a mesh."""
    out = torch.zeros((num_users,), dtype=torch.float32, device=u.device)
    for b, p in zip(by_user, preds_u):
        mask = assemble.history_mask(b)
        obs = (torch.square(p - mask) * mask).sum(dim=1)
        if mean:
            obs = obs / safe_len(b)
        x = assemble.read_rows(u, b)
        loss = obs + uobs * ((x @ gram) * x).sum(dim=1)
        if halve:
            loss = loss * 0.5
        assemble.scatter_bucket_vector(out, b, loss)
    return share_rows(out, by_user)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------

# Keep the loss pass's gathered [N, L, d] slabs for the following
# U-sweep only when they all fit comfortably in device memory; above
# this the sweep gathers again.
FUSE_BUDGET_BYTES = 4 << 30


def user_losses(user_emb: torch.Tensor, item_emb: torch.Tensor,
                gramian: torch.Tensor, by_user, num_users: int, uobs: float,
                *, halve: bool, dtype=None) -> torch.Tensor:
    """Per-user losses (reference ials.h:70-86 / safer2.h:85-101):

    L_u = sum_h (v^T u - 1)^2 / |H_u| + uobs * u^T G u   [ / 2 if halve ]

    Absent users keep loss 0."""
    return gather_and_losses(item_emb, by_user, user_emb, gramian,
                             num_users, uobs, halve=halve, dtype=dtype,
                             budget_bytes=0)[0]


def gather_and_losses(table_other: torch.Tensor, buckets, probe_table,
                      gramian: torch.Tensor, num_rows: int, uobs: float, *,
                      halve: bool, dtype=None,
                      budget_bytes: int = FUSE_BUDGET_BYTES):
    """Per-row losses of the carried model, returning the gathered
    history slabs for ``solve_sweep(pre_list=...)`` so the U-sweep that
    follows reuses them (the models move the reference's end-of-epoch
    loss pass to the top of the next epoch, where it reads the same
    frozen tables the U-step does; see ``SAFER2._epoch``).

    Returns ``(loss [num_rows], pre_list or None)``, one ``pre`` entry
    per bucket. The slabs are gathered from ``table_other`` cast to
    ``dtype`` once, and the budget counts their bytes in it. On a
    mesh the losses are shared (every rank holds them whole) and the
    slabs are the rank's own buckets'."""
    dim = table_other.shape[1]
    table_other = assemble.cast(table_other, dtype)
    # wide (streamed) buckets keep no slab and get a None entry
    total = sum(b.n_rows * b.width for b in buckets
                if not assemble.is_wide(b, dim)) * dim * \
        table_other.element_size()
    keep = total <= budget_bytes
    out = torch.zeros((num_rows,), dtype=torch.float32,
                      device=table_other.device)
    pre = [] if keep else None
    for b in buckets:
        x = assemble.read_rows(probe_table, b)
        if assemble.is_wide(b, dim):
            obs = assemble.wide_obs(table_other, b, x) / safe_len(b)
            emb = mask = None
        else:
            emb, mask = assemble.gather_history(table_other, b)
            p = assemble.rowwise_dot(emb, x)
            obs = (torch.square(p - 1.0) * mask).sum(dim=1) / safe_len(b)
        quad = uobs * ((x @ gramian) * x).sum(dim=1)
        loss = obs + quad
        if halve:
            loss = loss * 0.5
        assemble.scatter_bucket_vector(out, b, loss)
        if keep:
            pre.append(None if emb is None else (emb, mask))
    return share_rows(out, buckets), pre


def ials_reg(length: torch.Tensor, num_choices: int, reg: float,
             reg_exp: float, uobs: float) -> torch.Tensor:
    """Frequency-scaled regularizer reg*(|H| + uobs*n)^exp
    (reference ials.h:310-315)."""
    base = length.to(torch.float32) + uobs * num_choices
    if reg_exp == 1.0:
        return reg * base
    return reg * torch.pow(base, reg_exp)


def normal_init(generator: torch.Generator, rows: int, dim: int,
                stdev: float, device) -> torch.Tensor:
    """N(0, stdev/sqrt(dim)) init (reference recommender.h:61-67 with the
    adjusted stdev of ials.h:47). The draws come from ``generator`` and
    differ from the JAX package's; ``interop.state_from_jax`` carries
    that package's tables across where the two must start equal."""
    return torch.randn((rows, dim), generator=generator, device=device,
                       dtype=torch.float32) * (stdev / (dim ** 0.5))
