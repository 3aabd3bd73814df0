"""Fixed-shape serving engine (the counterpart of
``safer2_recommender_tpu/serving.py``).

``Recommender.recommend()`` builds a fresh ``FoldInData`` per call, its
bucket widths and row counts following each batch's histories, and runs
the fold-in op by op from Python. ``Server`` packs every request batch
onto a small static shape ladder (batch-size rung x history-width rung)
and builds ONE program per rung pair on its first use: on the card a
CUDA graph captured once and replayed for every later batch of that
shape (the JAX package compiles one XLA program per pair instead); on
the CPU a plain callable over the same static buffers. ``num_compiles``
counts the programs, so a test or a monitor can assert that steady-state
serving builds no new one.

Where a model's fold-in runs another algorithm for narrow buckets than
for wide ones (the ++ models at dim >= 128 solve a bucket of width <=
dim / 2 exactly by one Woodbury solve, a wider one by blockwise sweeps;
``Recommender._fold_in_split``), a batch is split in two sub-batches,
the short histories under a width rung <= dim / 2, so that every user
gets what length bucketing (``recommend``) gives them. Each sub-batch
runs the program of its own rung pair: whether a batch holds a long
history or not, it replays programs that other batches built.

Each program owns static buffers: the packed history (``row_ids``,
``col_ids``, ``length``, ``excl``) and the top-k ids it writes. A
request copies its packed history into them and replays the graph. The
frozen side of the model (item table, Gramian) and the state-only part
of the fold-in (``Recommender._fold_in_prep``: the eigenbasis, whose warm
refresh reads the host) live in buffers shared by all programs; when
``model.state`` is replaced (another epoch, a restore) they are
refreshed in place before the next batch, so the graphs serve the new
state without a new capture.

Id spaces: the solver-order item permutation is applied on the HOST
while the batch is packed, and the returned ids are decoded the same
way; the device never sees original ids.

``chol_inverse`` launches (``ops/block_chol.LAUNCHES``) are counted where
they run: the eager warm-up before a capture counts its own, the capture
counts none, and each replay adds the launches the capture recorded.

``recommend_stream`` packs and dispatches batch k+1 before it fetches
batch k. Batch k's ids are queued for copy into a pinned host buffer of
its own, with an event, before batch k+1's replay overwrites the output
buffer; the fetch waits on that event.

On a mesh (the model's ``mesh``) the rung sizes are multiples of 8 x
shards and every rank packs the whole batch, then keeps its block of
each bucket's rows: its program folds in and ranks those rows alone (a
CUDA graph holds the rank's compute, never a collective: gloo's cannot
be captured), and the ids are all-gathered after the replay, so every
rank returns the whole batch.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch.data.dataset import (Bucket, Dataset,
                                                       FoldInData,
                                                       _round_up,
                                                       _segment_arange)
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.utils.device import f32_matmul
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _tensors(tree):
    """The tensors of a nest of tuples (None leaves skipped)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    if tree is None:
        return []
    raise TypeError(f"fold-in prep holds a {type(tree).__name__}")


def _clone(tree):
    if isinstance(tree, tuple):
        return tuple(_clone(x) for x in tree)
    return None if tree is None else tree.clone()


class _Program:
    """One shape key's program: its static input buffers, the fold they
    make, and, on the card, the captured graph and its output buffer.

    ``shapes`` is ``((B, W),)``: one bucket of B rows of width W."""

    def __init__(self, server: "Server", shapes: Tuple[Tuple[int, int], ...]):
        model = server.model
        dev, ni = model.device, model.num_items
        i64 = dict(dtype=torch.int64, device=dev)
        ((B, W),) = shapes
        self.inputs = dict(excl=torch.full((B, W), ni, **i64),
                           row=torch.zeros(B, **i64),
                           col=torch.zeros((B, W), **i64),
                           length=torch.zeros(B, **i64))
        # a contiguous bucket: its write-back is a slice of the fold-in
        # table, never a masked scatter (a host read); on a mesh, the
        # rank's block of the batch's bucket, solved into the rank's own
        # table (no row is shared)
        bucket = Bucket(row_ids=self.inputs["row"],
                        col_ids=self.inputs["col"],
                        length=self.inputs["length"], row_start=0,
                        contiguous=True, mesh=model.mesh, shared=False)
        # gt, gt_len and hist_size are read by evaluation only
        fold = FoldInData(
            by_user=(bucket,), excl=self.inputs["excl"],
            gt=torch.full((B, 1), ni, **i64),
            gt_len=torch.zeros(B, **i64),
            hist_size=torch.zeros(B, device=dev),
            n_eval=B, n_pad=B, num_items=ni, nnz=0)
        state, prep = server._frozen

        def fn() -> torch.Tensor:
            ue = model._fold_in(state, fold, prep)
            return model._recommend_ids(ue, state.item_emb, fold.excl,
                                        k=server.k, approx=server.approx)

        self.fn = fn
        self.graph = None
        self.out = None
        self.replays = 0
        # chol_inverse launches recorded in the capture, by r; each replay
        # adds them to block_chol.LAUNCHES
        self.capture_launches = {r: 0 for r in block_chol.KERNEL_SIZES}
        if dev.type == "cuda":
            self._capture(server, shapes)

    def _capture(self, server: "Server", shapes) -> None:
        # the model's card, whichever is current (torch.cuda.graph
        # captures on a stream of the current device)
        dev = self.inputs["excl"].device
        with torch.cuda.device(dev):
            self._capture_on(server, shapes, dev)

    def _capture_on(self, server: "Server", shapes, dev) -> None:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn()       # warm-up: builds kernels, loads modules
        torch.cuda.current_stream(dev).wait_stream(side)
        if server._pool is None:
            # one pool for every program's graph: a replay may reuse
            # another graph's scratch, which is safe because each
            # replay's ids are queued for copy out before the next one
            server._pool = torch.cuda.graph_pool_handle()
        before = dict(block_chol.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=server._pool):
                self.out = self.fn()
        except RuntimeError as e:
            raise RuntimeError(
                f"Server: CUDA graph capture failed at rung pair(s) "
                f"(B, W) = {list(shapes)}: {e}") from e
        self.capture_launches = {r: block_chol.LAUNCHES[r] - before[r]
                                 for r in block_chol.KERNEL_SIZES}
        # a capture records the kernels and runs none: they are counted
        # where they run, at each replay
        for r, n in self.capture_launches.items():
            block_chol.LAUNCHES[r] -= n
        self.graph = graph

    def run(self, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Copy a packed batch into the static inputs and run: replay the
        graph on the card, call the program on the CPU. The returned
        ids tensor is overwritten by the next run."""
        for name, src in packed.items():
            self.inputs[name].copy_(src, non_blocking=True)
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        self.replays += 1
        for r, n in self.capture_launches.items():
            block_chol.LAUNCHES[r] += n
        return self.out


class Server:
    """Fixed-shape serving over a trained model.

    Build it after training or a checkpoint restore (with
    ``load_checkpoint_meta``); it follows the model's id permutation and
    state by identity. ``k`` and ``approx`` are baked into the programs
    (see ``Recommender.recommend`` for the approx trade-off).

    Its ids follow ``recommend()``. For the ++ models at dim >= 128 that
    departs from the JAX ``Server``, which packs a batch as one bucket
    and so runs its short histories (<= dim / 2 items) through the block
    sweeps too; here they get recommend()'s exact Woodbury solve.
    """

    def __init__(self, model, k: int = 100, approx: bool = False,
                 batch_sizes: Tuple[int, ...] = (64, 512, 4096),
                 widths: Tuple[int, ...] = (32, 128, 512)):
        self.model = model
        self.k = int(k)
        self.approx = bool(approx)
        # rung sizes split evenly over the mesh, in multiples of 8
        self._mult = 8 * mesh_lib.num_shards(model.mesh)
        self.batch_sizes = tuple(sorted(
            {max(_round_up(int(b), self._mult), self._mult)
             for b in batch_sizes}))
        self.widths = tuple(sorted({int(w) for w in widths}))
        self.replays = 0
        self._programs: Dict[tuple, _Program] = {}
        self._pool = None
        self._state_src = None
        self._frozen = None       # (state over static item buffers, prep)
        self._perm_src = None
        self._perm = None
        self._order = None
        self._refresh_perm()

    # ---- id permutation (host-side) and the served state ------------------

    def _refresh_perm(self) -> None:
        src = self.model._item_perm
        if src is self._perm_src:
            return
        self._perm_src = src
        if src is None:
            self._perm = self._order = None
        else:
            self._perm = src.cpu().numpy()
            self._order = self.model._item_order.cpu().numpy()

    def _refresh_state(self) -> None:
        """Point the programs' shared buffers at ``model.state``: copied
        in place, so captured graphs keep reading the same addresses."""
        state = self.model.state
        if state is self._state_src:
            return
        prep = self.model._fold_in_prep(state)
        if self._frozen is None:
            self._frozen = (state.replace(
                item_emb=state.item_emb.clone(),
                item_gramian=state.item_gramian.clone()), _clone(prep))
        else:
            frozen, frozen_prep = self._frozen
            dst = [frozen.item_emb, frozen.item_gramian] + _tensors(
                frozen_prep)
            src = [state.item_emb, state.item_gramian] + _tensors(prep)
            if [t.shape for t in dst] != [t.shape for t in src]:
                raise ValueError("Server: the model's state changed shape; "
                                 "build a new Server")
            for d, s in zip(dst, src):
                d.copy_(s)
        self._state_src = state

    # ---- shape ladder -------------------------------------------------------

    @property
    def num_compiles(self) -> int:
        """Programs built so far, one per rung pair used (the JAX
        package's compiled programs): on the card, CUDA graphs captured;
        on the CPU, callables. Steady-state serving holds it constant."""
        return len(self._programs)

    def programs(self) -> Dict[tuple, _Program]:
        """The built programs by shape key: one (B, W) rung pair per
        bucket (B the rank's rows of the rung on a mesh)."""
        return dict(self._programs)

    def _rung(self, ladder: Tuple[int, ...], x: int) -> int:
        for r in ladder:
            if x <= r:
                return r
        # beyond the ladder: the next power of two (built once, then
        # reused like any other rung); logged because a production
        # ladder should be sized to its traffic
        r = max(_round_up(_next_pow2(x), self._mult), self._mult)
        _log.info("serving shape ladder extended to %d (request "
                  "exceeded %d)", r, ladder[-1])
        return r

    def _program(self, shapes) -> _Program:
        prog = self._programs.get(shapes)
        if prog is None:
            prog = self._programs[shapes] = _Program(self, shapes)
        return prog

    # ---- batch packing ------------------------------------------------------

    def _pack(self, users: np.ndarray, items: np.ndarray):
        """Split a request into rung-shaped sub-batches; yields
        (distinct user ids, shape key, packed host arrays) per sub-batch;
        user j's ids are row j of its program's output."""
        if users.shape != items.shape:
            raise ValueError(f"request user/item id arrays differ in "
                             f"shape: {users.shape} vs {items.shape}")
        if items.size:
            lo, hi = int(items.min()), int(items.max())
            if lo < 0 or hi >= self.model.num_items:
                raise ValueError(
                    f"request item ids must be in [0, "
                    f"{self.model.num_items}); got range [{lo}, {hi}]")
        uniq, inv = np.unique(users, return_inverse=True)
        counts = np.bincount(inv, minlength=uniq.size)
        order = np.argsort(inv, kind="stable")
        items = np.ascontiguousarray(items)[order].astype(np.int64)
        if self._perm is not None:
            items = self._perm[items]
        # where the model's fold-in runs another algorithm at and below a
        # width (Recommender._fold_in_split), the short rows are a
        # sub-batch of their own with a width rung at or below it, as
        # length bucketing would give them
        split = self.model._fold_in_split()
        if split is None:
            groups = [(np.arange(uniq.size), self.widths)]
        else:
            short = counts <= split
            narrow = tuple(sorted({w for w in self.widths if w < split}
                                  | {split}))
            groups = [(np.flatnonzero(short), narrow),
                      (np.flatnonzero(~short), self.widths)]
        max_b = self.batch_sizes[-1]
        starts = np.concatenate(([0], np.cumsum(counts)))
        for sel, ladder in groups:
            for lo in range(0, sel.size, max_b):
                part = sel[lo:lo + max_b]
                c = counts[part]
                got = items[np.repeat(starts[part], c) + _segment_arange(c)]
                yield (uniq[part],) + self._pack_one(c, got, ladder)

    def _pack_one(self, counts: np.ndarray, items: np.ndarray,
                  ladder: Tuple[int, ...]):
        """One sub-batch as one bucket on the width rungs ``ladder``:
        (shape key, packed host arrays)."""
        n = counts.size
        B = self._rung(self.batch_sizes, n)
        W = self._rung(ladder, int(counts.max()))
        off = _segment_arange(counts)
        row_of = np.repeat(np.arange(n), counts)
        col = np.zeros((B, W), np.int64)
        col[row_of, off] = items
        row = np.full(B, B, np.int64)   # pads out of bounds, as in JAX
        row[:n] = np.arange(n)
        length = np.zeros(B, np.int64)
        length[:n] = counts
        excl = np.full((B, W), self.model.num_items, np.int64)
        excl[row_of, off] = items
        packed = {"row": row, "col": col, "length": length, "excl": excl}
        if self.model.mesh is not None:
            return self._shard(B, W, packed)
        return ((B, W),), packed

    def _shard(self, B: int, W: int, packed):
        """This rank's block of a packed sub-batch on a (B, W) rung: its
        shape key and packed arrays. The blocks are contiguous, so the
        ids all-gathered from every rank in rank order keep each user's
        row."""
        lo, hi = mesh_lib.row_range(self.model.mesh, B)
        bl = hi - lo
        row = packed["row"][lo:hi]
        out = {"row": np.where(row < B, row - lo, bl),
               **{k: packed[k][lo:hi] for k in ("col", "length", "excl")}}
        return ((bl, W),), out

    # ---- serving surface ----------------------------------------------------

    def _dispatch(self, histories):
        if isinstance(histories, Dataset):
            u, i = histories.user_ids, histories.item_ids
        else:
            u, i = histories
            u = np.asarray(u, np.int32)
            i = np.asarray(i, np.int32)
        self._refresh_perm()
        on_card = self.model.device.type == "cuda"
        out = []
        with f32_matmul():
            for users, shapes, packed in self._pack(u, i):
                self._refresh_state()
                prog = self._program(shapes)
                src = {k: torch.from_numpy(v) for k, v in packed.items()}
                if on_card:
                    src = {k: v.pin_memory() for k, v in src.items()}
                ids = prog.run(src)
                self.replays += 1
                if self.model.mesh is not None:
                    # after the replay: the graph holds no collective
                    ids = mesh_lib.all_gather_rows(self.model.mesh, ids)
                if on_card:
                    host = torch.empty(ids.shape, dtype=ids.dtype,
                                       pin_memory=True)
                    host.copy_(ids, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(ids.device))
                    # src stays referenced until the copies have run
                    out.append((users, host, done, src))
                else:
                    out.append((users, ids, None, src))
        return out

    def _fetch(self, dispatched) -> Tuple[np.ndarray, np.ndarray]:
        if not dispatched:   # empty request batch -> empty result
            return (np.zeros(0, np.int32),
                    np.zeros((0, self.k), np.int64))
        us, ids = [], []
        for users, host, done, _ in dispatched:
            if done is not None:
                done.synchronize()
            arr = host.numpy()[:users.size]
            if self._order is not None:
                arr = self._order[arr]
            us.append(users)
            ids.append(arr)
        # sub-batches of short and long rows: back to ascending user ids,
        # as recommend() returns them
        users = np.concatenate(us)
        order = np.argsort(users, kind="stable")
        return users[order], np.concatenate(ids, axis=0)[order]

    def recommend(self, histories) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for one request batch: a ``Dataset`` (or ``(user_ids,
        item_ids)`` arrays) of interactions in ORIGINAL id space.
        Returns ``(user_ids [n], item_ids [n, k])`` like
        ``Recommender.recommend``."""
        return self._fetch(self._dispatch(histories))

    def recommend_stream(self, batches: Iterable) -> Iterator[
            Tuple[np.ndarray, np.ndarray]]:
        """``recommend`` over a stream, one batch of pipelining deep:
        batch k+1 is packed and dispatched before batch k's result is
        fetched. A batch that fails to dispatch still lets the one
        before it be yielded before the error is raised."""
        prev = None
        for h in batches:
            try:
                disp = self._dispatch(h)
            except Exception:
                if prev is not None:
                    yield self._fetch(prev)
                raise
            if prev is not None:
                yield self._fetch(prev)
            prev = disp
        if prev is not None:
            yield self._fetch(prev)
