"""Data layer: CSV ingest -> bucketed COO/CSR tensors on a device.

The PyTorch counterpart of ``safer2_recommender_tpu/data/dataset.py``.
The host-side bucketing is the same numpy code, so the bucket arrays,
the solver-order permutations, the history sizes and ``item_reg`` equal
the JAX package's exactly (the model tables are only meaningful
relative to that order, see ``models/base.py::_dd_fingerprint``).

Ragged per-row histories are bucketed by length into power-of-two
padded tiles ``Bucket(row_ids[N], col_ids[N, L], length[N])``:

  * padded rows:    row_ids == num_rows (out of bounds), length == 0
  * padded columns: col_ids == 0 (masked via length)

Torch index ops raise on the out-of-bounds pad ids where JAX dropped or
clamped them, so every consumer masks pads before it indexes
(``ops/assemble.py``).

On a mesh (``parallel/mesh.py``) every rank buckets the whole dataset,
as each JAX process parses the whole CSV, with ``row_multiple`` times
the shard count so every bucket's rows divide evenly, and keeps only its
contiguous block of each bucket's rows (and of the fold-in's per-row
arrays): the shard ``P("data")`` gives its device in the JAX package.
The per-id vectors (history sizes, ``item_reg``, the permutations) stay
whole on every rank.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.utils.device import DEFAULT_DEVICE
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)


# --------------------------------------------------------------------------
# Host-side dataset
# --------------------------------------------------------------------------


def _read_csv_native(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    from safer2_recommender_tpu_torch import native

    lib = native.load_csv_reader()
    if lib is None:
        return None
    import ctypes

    n = lib.frt_csv_count(path.encode())
    if n < 0:
        return None
    users = np.empty(n, dtype=np.int32)
    items = np.empty(n, dtype=np.int32)
    got = lib.frt_csv_read(
        path.encode(),
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        items.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
    )
    if got != n:
        return None
    return users, items


def _read_csv_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """numpy's reader (a ``.gz`` path is decompressed on the fly); the
    port needs no pandas."""
    arr = np.loadtxt(path, dtype=np.int32, delimiter=",", skiprows=1,
                     ndmin=2, usecols=(0, 1))
    return arr[:, 0].copy(), arr[:, 1].copy()


class Dataset:
    """Host-side interaction set as COO arrays in file tuple order.

    ``num_users``/``num_items`` are ``max id + 1`` (id gaps keep
    embedding rows, matching the reference's table sizing).
    """

    def __init__(self, user_ids: np.ndarray, item_ids: np.ndarray):
        if user_ids.shape != item_ids.shape:
            raise ValueError(f"user/item id arrays differ in shape: "
                             f"{user_ids.shape} vs {item_ids.shape}")
        self.user_ids = np.ascontiguousarray(user_ids, dtype=np.int32)
        self.item_ids = np.ascontiguousarray(item_ids, dtype=np.int32)
        self.nnz = int(user_ids.shape[0])
        self.max_user = int(user_ids.max()) if self.nnz else -1
        self.max_item = int(item_ids.max()) if self.nnz else -1
        self.num_users = self.max_user + 1
        self.num_items = self.max_item + 1
        _log.info(
            "max_user=%d\tmax_item=%d\tdistinct user=%d\tdistinct item=%d"
            "\tnum_tuples=%d",
            self.max_user, self.max_item,
            int((np.bincount(self.user_ids,
                             minlength=self.num_users) > 0).sum()),
            int((np.bincount(self.item_ids,
                             minlength=self.num_items) > 0).sum()),
            self.nnz,
        )

    @classmethod
    def from_csv(cls, path: str) -> "Dataset":
        """Read a 2-column uid,sid CSV (header discarded). A missing
        ``foo.csv`` falls back to ``foo.csv.gz`` (the bundled ML-1M
        fixture ships gzipped), read through numpy."""
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            return cls(*_read_csv_python(path + ".gz"))
        out = _read_csv_native(path)
        if out is None:
            out = _read_csv_python(path)
        return cls(*out)

    def num_tuples(self) -> int:
        return self.nnz


# --------------------------------------------------------------------------
# Bucketed layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A padded tile of rows whose histories all fit in ``L`` columns.

    ``contiguous`` buckets (from ``DeviceData.build``'s solver-order
    renumbering) own the table rows ``[row_start, row_start + n_real)``
    and their padded window ``[row_start, row_start + n_rows)`` lies
    inside the table, so row reads and write-backs are plain slices.
    ``row_ids`` stays authoritative either way.

    A bucket sharded over ``mesh`` holds one rank's block of
    ``global_rows`` rows; the choices that the JAX package makes from a
    bucket's shape (``assemble.is_wide``, the solve batches of
    ``models/common.py``) read the global shape, so every rank takes
    the route the whole bucket takes. A sweep shares its solved rows
    over ``mesh`` into every rank's copy of the table
    (``models/common.py::share_rows``) unless ``shared`` is False: the
    ``Server``'s rank-local fold-in table, whose rows no other rank
    reads.
    """

    row_ids: torch.Tensor    # [N] int64; padded rows == num_rows
    col_ids: torch.Tensor    # [N, L] int64; padded cols == 0 (masked)
    length: torch.Tensor     # [N] int64; 0 on padded rows
    row_start: Optional[int] = None   # host int (contiguous only)
    contiguous: bool = False
    mesh: Optional[mesh_lib.Mesh] = None   # the mesh it is split over
    shared: bool = True      # solved rows shared over ``mesh``

    @property
    def n_rows(self) -> int:
        return self.row_ids.shape[0]

    @property
    def global_rows(self) -> int:
        return self.n_rows * mesh_lib.num_shards(self.mesh)

    @property
    def width(self) -> int:
        return self.col_ids.shape[1]

    def to(self, device) -> "Bucket":
        return dataclasses.replace(
            self, row_ids=self.row_ids.to(device),
            col_ids=self.col_ids.to(device), length=self.length.to(device))

    def shard(self, mesh) -> "Bucket":
        """This rank's contiguous block of the rows (all without a mesh);
        a contiguous bucket's block is a contiguous window too."""
        lo, hi = mesh_lib.row_range(mesh, self.n_rows)
        return dataclasses.replace(
            self, row_ids=self.row_ids[lo:hi], col_ids=self.col_ids[lo:hi],
            length=self.length[lo:hi],
            row_start=(self.row_start + lo if self.contiguous else None),
            mesh=mesh)


def _t(x: np.ndarray) -> torch.Tensor:
    """Host int array -> int64 CPU tensor (torch indexes with int64)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_edges(max_len: int, min_bucket: int,
                  growth: int) -> Sequence[int]:
    if min_bucket < 1 or growth < 2:
        raise ValueError(
            f"min_bucket >= 1 and growth >= 2 required (got {min_bucket}, "
            f"{growth}); the width ladder must strictly grow")
    edges = []
    e = min_bucket
    while True:
        edges.append(e)
        if e >= max_len:
            break
        e *= growth
    return edges


def _build_buckets(
    sorted_rows: np.ndarray,      # [nnz] row id per tuple, sorted ascending
    sorted_cols: np.ndarray,      # [nnz] col id per tuple (same order)
    num_rows: int,
    min_bucket: int,
    row_multiple: int,
    growth: int,
    max_rows: int = 0,
    max_tuples: int = 0,
):
    """Group rows by history length into padded tiles whose widths grow
    by ``growth`` per bucket; ``max_rows``/``max_tuples`` (0 = unbounded)
    split oversized buckets into row chunks so a sweep never holds more
    than a bounded slab of [rows, d, d] systems / [rows, L, d] gathers.
    Returns buckets of CPU tensors (``DeviceData.build`` moves them)."""
    if sorted_rows.size == 0:
        return ()
    change = np.empty(sorted_rows.size, dtype=bool)
    change[0] = True
    np.not_equal(sorted_rows[1:], sorted_rows[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    uniq = sorted_rows[starts]
    counts = np.diff(np.append(starts, sorted_rows.size))
    max_len = int(counts.max())
    edges = _bucket_edges(max_len, min_bucket, growth)

    buckets = []
    prev = 0
    for edge in edges:
        sel = (counts > prev) & (counts <= edge)
        prev = edge
        ids = uniq[sel]
        if ids.size == 0:
            continue
        st = starts[sel]
        ct = counts[sel]
        chunk = ids.size
        if max_rows > 0:
            chunk = min(chunk, max_rows)
        if max_tuples > 0:
            chunk = min(chunk, max(max_tuples // edge, row_multiple))
        chunk = _round_up(chunk, row_multiple)
        for lo in range(0, ids.size, chunk):
            hi = min(lo + chunk, ids.size)
            n = hi - lo
            n_pad = _round_up(n, row_multiple)
            row_ids = np.full(n_pad, num_rows, dtype=np.int32)
            row_ids[:n] = ids[lo:hi]
            length = np.zeros(n_pad, dtype=np.int32)
            length[:n] = ct[lo:hi]
            col_ids = np.zeros((n_pad, edge), dtype=np.int32)
            cts = ct[lo:hi]
            row_of = np.repeat(np.arange(n), cts)
            off = _segment_arange(cts)
            gidx = np.repeat(st[lo:hi], cts) + off
            col_ids[row_of, off] = sorted_cols[gidx]
            buckets.append(Bucket(row_ids=_t(row_ids), col_ids=_t(col_ids),
                                  length=_t(length)))
    return tuple(buckets)


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] without a Python loop."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


def _n_real(b: Bucket) -> int:
    return int((b.length.cpu() > 0).sum())


def _solver_order(buckets, num_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Solver-order renumbering of one side's ids.

    New id = position of the row in the concatenation of the buckets'
    real rows (every bucket owns a contiguous id range); ids absent from
    every bucket follow in old-id order. Returns
    ``(perm old->new, order new->old)`` as int32 arrays.
    """
    parts = [b.row_ids.cpu().numpy()[:_n_real(b)] for b in buckets]
    active = (np.concatenate(parts) if parts
              else np.zeros(0, np.int64)).astype(np.int64)
    perm = np.full(num_rows, -1, np.int64)
    perm[active] = np.arange(active.size)
    gaps = np.flatnonzero(perm < 0)
    perm[gaps] = active.size + np.arange(gaps.size)
    order = np.empty(num_rows, np.int64)
    order[perm] = np.arange(num_rows)
    return perm.astype(np.int32), order.astype(np.int32)


def _renumber_buckets(buckets, perm_other: np.ndarray,
                      num_rows: int) -> Tuple[Bucket, ...]:
    """Rewrite one side's buckets into solver order: row ids become the
    bucket's contiguous range (``contiguous=True`` when the padded
    window fits the table: only the last bucket's pad can overhang),
    col ids map through the OTHER side's permutation."""
    out, start = [], 0
    for b in buckets:
        n = _n_real(b)
        row_ids = np.full(b.n_rows, num_rows, dtype=np.int32)
        row_ids[:n] = start + np.arange(n, dtype=np.int32)
        col_ids = perm_other[b.col_ids.cpu().numpy()].astype(np.int32)
        contig = start + b.n_rows <= num_rows
        out.append(Bucket(
            row_ids=_t(row_ids),
            col_ids=_t(col_ids),
            length=b.length,
            row_start=start if contig else None,
            contiguous=contig,
        ))
        start += n
    return tuple(out)


def _bucket_budgets(dim: int, budget_bytes: int) -> Tuple[int, int]:
    """Per-bucket row/tuple caps from the embedding dim (0 = no cap):
    one [rows, d, d] slab, or one [rows, L, d] gather (~2 copies), of
    ``budget_bytes``."""
    if dim <= 0:
        return 0, 0
    max_rows = max(budget_bytes // (dim * dim * 4), 64)
    max_tuples = max(budget_bytes // (2 * dim * 4), 4096)
    return int(max_rows), int(max_tuples)


def _csr_views(ids: np.ndarray, other: np.ndarray):
    """Group tuples by ``ids``; returns (grouped ids, other). A row's
    history is a set, so within-group order is free; already-grouped
    input (the usual user-major CSV) costs one O(n) check."""
    if ids.size == 0 or bool((ids[1:] >= ids[:-1]).all()):
        return ids, other
    order = np.argsort(ids)
    return ids[order], other[order]


@dataclasses.dataclass(frozen=True)
class DeviceData:
    """Training dataset (both adjacency views) on a device.

    Every per-row array here, and every model table trained against it,
    lives in solver-order id space (``_solver_order``): ``*_perm`` maps
    original -> solver ids, ``*_order`` maps back. ``user_hist_size`` /
    ``item_hist_size`` are 0 at id gaps; ``item_reg`` is the SAFER
    family's per-item statistic sum(1/|H_u|) over the item's users.
    ``mesh`` is the mesh the buckets are sharded over (None: whole).
    """

    by_user: Tuple[Bucket, ...]
    by_item: Tuple[Bucket, ...]
    user_hist_size: torch.Tensor   # [num_users] f32 (solver order)
    item_hist_size: torch.Tensor   # [num_items] f32 (solver order)
    item_reg: torch.Tensor         # [num_items] f32 (solver order)
    num_users: int
    num_items: int
    nnz: int
    user_perm: torch.Tensor        # [num_users] int64 old->new
    item_perm: torch.Tensor        # [num_items] int64 old->new
    user_order: torch.Tensor       # [num_users] int64 new->old
    item_order: torch.Tensor       # [num_items] int64 new->old
    mesh: Optional[mesh_lib.Mesh] = None

    @property
    def device(self) -> torch.device:
        return self.item_reg.device

    @classmethod
    def build(
        cls,
        ds: Dataset,
        device=DEFAULT_DEVICE,
        num_users: Optional[int] = None,
        num_items: Optional[int] = None,
        min_bucket: int = 8,
        row_multiple: int = 8,
        growth: int = 2,
        dim: int = 0,
        memory_budget_bytes: int = 2 << 30,
        mesh: Optional[mesh_lib.Mesh] = None,
    ) -> "DeviceData":
        device = mesh_lib.place(device, mesh)
        num_users = num_users or ds.num_users
        num_items = num_items or ds.num_items
        row_multiple = row_multiple * mesh_lib.num_shards(mesh)
        max_rows, max_tuples = _bucket_budgets(dim, memory_budget_bytes)

        u_rows, u_cols = _csr_views(ds.user_ids, ds.item_ids)
        by_user = _build_buckets(
            u_rows, u_cols, num_users,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        i_rows, i_cols = _csr_views(ds.item_ids, ds.user_ids)
        by_item = _build_buckets(
            i_rows, i_cols, num_items,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        perm_u, order_u = _solver_order(by_user, num_users)
        perm_i, order_i = _solver_order(by_item, num_items)
        by_user = _renumber_buckets(by_user, perm_i, num_users)
        by_item = _renumber_buckets(by_item, perm_u, num_items)

        uh = np.bincount(ds.user_ids,
                         minlength=num_users).astype(np.float32)
        ih = np.bincount(ds.item_ids,
                         minlength=num_items).astype(np.float32)
        ireg = np.bincount(ds.item_ids, weights=1.0 / uh[ds.user_ids],
                           minlength=num_items).astype(np.float32)

        f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
        ids = lambda x: _t(x).to(device)
        return cls(
            by_user=tuple(b.shard(mesh).to(device) for b in by_user),
            by_item=tuple(b.shard(mesh).to(device) for b in by_item),
            user_hist_size=f32(uh[order_u]),
            item_hist_size=f32(ih[order_i]),
            item_reg=f32(ireg[order_i]),
            num_users=num_users,
            num_items=num_items,
            nnz=ds.nnz,
            user_perm=ids(perm_u),
            item_perm=ids(perm_i),
            user_order=ids(order_u),
            item_order=ids(order_i),
            mesh=mesh,
        )


@dataclasses.dataclass(frozen=True)
class FoldInData:
    """Held-out evaluation data ("strong generalization").

    Evaluation folds in fresh user embeddings from the held-out users'
    training interactions with item embeddings frozen, then scores the
    full catalog. Eval users get compact row ids 0..n_eval-1; ``gt`` and
    ``excl`` are padded with ``num_items`` (never matches a real item).
    Item ids here are in ORIGINAL id space; models remap them
    (``models/base.py::_permute_fold``). On a ``mesh`` the buckets and
    the per-row arrays (``excl``, ``gt``, ``gt_len``, ``hist_size``) hold
    this rank's rows only; ``n_pad`` counts all of them.
    """

    by_user: Tuple[Bucket, ...]      # fold-in histories, compact rows
    excl: torch.Tensor               # [n_pad, Hmax] int64 history ids
    gt: torch.Tensor                 # [n_pad, Gmax] int64 ground truth
    gt_len: torch.Tensor             # [n_pad] int64 (0 => skip row)
    hist_size: torch.Tensor          # [n_pad] f32 fold-in history sizes
    n_eval: int
    n_pad: int
    num_items: int
    nnz: int
    mesh: Optional[mesh_lib.Mesh] = None

    @classmethod
    def build(
        cls,
        tr: Dataset,
        te: Dataset,
        num_items: int,
        device=DEFAULT_DEVICE,
        min_bucket: int = 8,
        row_multiple: int = 8,
        chunk: int = 1024,
        growth: int = 2,
        dim: int = 0,
        memory_budget_bytes: int = 2 << 30,
        mesh: Optional[mesh_lib.Mesh] = None,
    ) -> "FoldInData":
        device = mesh_lib.place(device, mesh)
        row_multiple = row_multiple * mesh_lib.num_shards(mesh)
        max_rows, max_tuples = _bucket_budgets(dim, memory_budget_bytes)
        uniq = np.unique(tr.user_ids)
        n_eval = uniq.size
        compact_u = np.searchsorted(uniq, tr.user_ids).astype(np.int32)
        n_pad = _round_up(max(n_eval, 1), max(chunk, row_multiple))

        u_rows, u_cols = _csr_views(compact_u, tr.item_ids)
        # The padded-row sentinel is out of bounds of the PADDED
        # [n_pad, dim] fold-in table, not just past n_eval.
        by_user = _build_buckets(
            u_rows, u_cols, n_pad,
            min_bucket, row_multiple, growth, max_rows, max_tuples)

        counts = np.bincount(compact_u, minlength=n_eval)
        hmax = int(counts.max()) if n_eval else 1
        excl = np.full((n_pad, hmax), num_items, dtype=np.int32)
        order = np.argsort(compact_u, kind="stable")
        row_of = compact_u[order]
        off = _segment_arange(counts[counts > 0]) if n_eval else (
            np.zeros(0, dtype=np.int64))
        excl[row_of, off] = tr.item_ids[order]

        # only te users that exist among tr users are evaluated
        te_mask = np.isin(te.user_ids, uniq)
        te_u = te.user_ids[te_mask]
        te_i = te.item_ids[te_mask]
        te_compact = np.searchsorted(uniq, te_u).astype(np.int32)
        gt_counts = np.bincount(te_compact, minlength=n_eval)
        gmax = int(gt_counts.max()) if gt_counts.size else 1
        gt = np.full((n_pad, max(gmax, 1)), num_items, dtype=np.int32)
        gorder = np.argsort(te_compact, kind="stable")
        grow = te_compact[gorder]
        goff = _segment_arange(gt_counts[gt_counts > 0]) if te_u.size else (
            np.zeros(0, dtype=np.int64))
        gt[grow, goff] = te_i[gorder]
        gt_len = np.zeros(n_pad, dtype=np.int32)
        gt_len[:n_eval] = gt_counts

        hist = np.zeros(n_pad, dtype=np.float32)
        hist[:n_eval] = counts

        lo, hi = mesh_lib.row_range(mesh, n_pad)
        return cls(
            by_user=tuple(b.shard(mesh).to(device) for b in by_user),
            excl=_t(excl[lo:hi]).to(device),
            gt=_t(gt[lo:hi]).to(device),
            gt_len=_t(gt_len[lo:hi]).to(device),
            hist_size=torch.from_numpy(hist[lo:hi]).to(device),
            n_eval=n_eval,
            n_pad=n_pad,
            num_items=num_items,
            nnz=tr.nnz,
            mesh=mesh,
        )
