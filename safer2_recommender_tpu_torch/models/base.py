"""Recommender base class: state, training loop, evaluation and serving
(the counterpart of ``safer2_recommender_tpu/models/base.py``).

Evaluation of a held-out dataset folds in fresh user embeddings with
the item table frozen, scores the whole catalog in chunks and ranks it
with history masked out; serving (``recommend``) is the same
computation returning the top-k ids.

On a mesh (``mesh=``, ``parallel/mesh.py``) the model's state is
replicated: ``initialize`` broadcasts rank 0's tables, every sweep
shares the rows each rank solved, and the quantile's draws come from a
generator seeded alike on every rank. Evaluation and ``recommend`` fold
in every row, then each rank scores its own block of rows and the
per-user results are gathered, so every rank returns the same numbers.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import (Dataset, DeviceData,
                                                       FoldInData)
from safer2_recommender_tpu_torch.evaluation.metrics import (
    DEFAULT_ALPHA_LIST,
    DEFAULT_K_LIST,
    EvaluationResult,
    topk_ids,
    topk_metrics,
)
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.ops import assemble, woodbury
from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       f32_matmul,
                                                       matmul_precision)
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME, span

_log = logging.getLogger(LOGGER_NAME)

ASM_DTYPES = {"auto": None, "f32": None, "bf16": torch.bfloat16}


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _dd_fingerprint(dd: DeviceData) -> Tuple[int, ...]:
    """Identity of a DeviceData's id universe + solver order:
    (num_users, num_items, nnz, crc32(user_order), crc32(item_order)),
    computed over int32 orders as the JAX package does, so the two
    packages agree on it for the same data."""
    return (dd.num_users, dd.num_items, dd.nnz,
            zlib.crc32(_host(dd.user_order).astype(np.int32).tobytes()),
            zlib.crc32(_host(dd.item_order).astype(np.int32).tobytes()))


@dataclasses.dataclass(frozen=True)
class MFState:
    """Model state. Tables and per-user vectors are in solver order.
    The JAX package's PRNG key lives on the model as a
    ``torch.Generator``."""

    user_emb: torch.Tensor      # [num_users, dim]
    item_emb: torch.Tensor      # [num_items, dim]
    item_gramian: torch.Tensor  # [dim, dim] cached V^T V (safer2.h:55)
    user_loss: torch.Tensor     # [num_users]
    dual_weight: torch.Tensor   # [num_users]
    xi: torch.Tensor            # 0-d smoothed-quantile estimate
    steps: int                  # epochs trained (selects SAFER2's
                                # Initialize-time xi warm start)
    eig_qu: torch.Tensor        # [dim, dim] warm eigenbasis of the user
                                # sweep's shared Gramian (Woodbury
                                # refresh, ops/woodbury.py::refresh_eigh)
    eig_qv: torch.Tensor        # [dim, dim] warm eigenbasis of the item
                                # sweep's shared Gramian

    def replace(self, **kw) -> "MFState":
        return dataclasses.replace(self, **kw)


class Recommender:
    """Base class. Subclasses implement ``_epoch`` and ``_fold_in``."""

    name = "base"

    def __init__(self, cfg: Config, num_users: int, num_items: int,
                 device=DEFAULT_DEVICE, mesh=None):
        if cfg.compute_dtype not in ASM_DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: choose "
                             f"from {sorted(ASM_DTYPES)}")
        self.cfg = cfg
        # the history slabs' assembly dtype (None: the tables' float32);
        # "auto" is float32 in the port (config.py)
        self.asm_dtype = ASM_DTYPES[cfg.compute_dtype]
        self.num_users = num_users
        self.num_items = num_items
        self.mesh = mesh
        self.device = mesh_lib.place(device, mesh)
        self.print_train_stats = False
        self.print_residual_stats = False
        self.print_var_stats = False

        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        user_emb = common.normal_init(self.generator, num_users, cfg.dim,
                                      cfg.stdev, self.device)
        item_emb = common.normal_init(self.generator, num_items, cfg.dim,
                                      cfg.stdev, self.device)
        self.state = MFState(
            user_emb=user_emb,
            item_emb=item_emb,
            item_gramian=item_emb.T @ item_emb,
            user_loss=torch.zeros(num_users, device=self.device),
            dual_weight=torch.full((num_users,), cfg.alpha,
                                   device=self.device),
            xi=torch.zeros((), device=self.device),
            steps=0,
            eig_qu=torch.eye(cfg.dim, device=self.device),
            eig_qv=torch.eye(cfg.dim, device=self.device),
        )
        self._user_perm = self._item_perm = None
        self._user_order = self._item_order = None
        self._dd_fp = None
        self._noted_dd_id = None
        self._fold_perm_cache = {}
        self._perm_warned = False

    # ---- reference API surface -------------------------------------------

    def set_print_train_stats(self, v: bool) -> None:
        self.print_train_stats = v

    def set_print_residual_stats(self, v: bool) -> None:
        self.print_residual_stats = v

    def set_print_var_stats(self, v: bool) -> None:
        self.print_var_stats = v

    def get_mean_weight(self) -> float:
        """Mean dual weight; tracks alpha when xi is accurate
        (reference safer2.h:812-817, Proposition C.1 hook)."""
        return float(self.state.dual_weight.mean())

    @f32_matmul()
    def initialize(self, dd: DeviceData) -> None:
        """Pre-training warm start; overridden by the SAFER family."""
        self._start(dd)

    def _start(self, dd: DeviceData) -> None:
        """The top of every ``initialize``: note the data's permutation
        and, on a mesh, hand every rank rank 0's tables."""
        self._note_perms(dd)
        self.broadcast_tables()

    def broadcast_tables(self) -> None:
        """On a mesh, set every rank's tables to rank 0's (and the
        Gramian to match), so the replicated state starts equal."""
        if self.mesh is None:
            return
        s = self.state
        u = mesh_lib.broadcast(self.mesh, s.user_emb.contiguous())
        v = mesh_lib.broadcast(self.mesh, s.item_emb.contiguous())
        self.state = s.replace(user_emb=u, item_emb=v,
                               item_gramian=v.T @ v)

    def _check_mesh(self, data) -> None:
        """``data`` (a DeviceData or FoldInData) must be sharded over the
        model's mesh, or neither is sharded."""
        want, got = self.mesh, data.mesh
        if (want is None) != (got is None) or (want is not None and (
                want.world_size, want.rank) != (got.world_size, got.rank)):
            raise ValueError(
                f"{type(data).__name__} was built for mesh {got!r}, the "
                f"model runs on {want!r}: build it with the model's mesh")

    def export_state(self, dd: DeviceData = None) -> dict:
        """Numpy view of the model state in ORIGINAL id space:
        ``out["user_emb"][u]`` is user ``u`` of the original Dataset.
        Returns user_emb, item_emb, user_loss, dual_weight and xi."""
        if dd is not None and self._dd_fp is not None \
                and _dd_fingerprint(dd) != self._dd_fp:
            raise ValueError(
                "export_state: the supplied DeviceData does not match the "
                "data this state was trained against; rows would come "
                "back misaligned")
        pu, pi = self._user_perm, self._item_perm
        if pu is None and dd is not None:
            pu, pi = dd.user_perm, dd.item_perm
        if pu is None:
            if self.state.steps > 0:
                raise ValueError(
                    "export_state on a trained state with no recorded id "
                    "permutation: if this state was restored from a "
                    "checkpoint, restore the id sidecar too "
                    "(CheckpointManager.restore_with_meta + "
                    "load_checkpoint_meta), or call initialize()/"
                    "train_epoch() with the training DeviceData first")
            pu = np.arange(self.num_users)
            pi = np.arange(self.num_items)
        else:
            pu, pi = _host(pu), _host(pi)
        s = self.state
        return {
            "user_emb": _host(s.user_emb)[pu],
            "item_emb": _host(s.item_emb)[pi],
            "user_loss": _host(s.user_loss)[pu],
            "dual_weight": _host(s.dual_weight)[pu],
            "xi": float(s.xi),
        }

    def checkpoint_meta(self) -> dict:
        """Id-space sidecar for ``CheckpointManager.save`` (format v2):
        the solver-order id orders and the training data's fingerprint,
        which make a checkpoint self-contained. None before any
        DeviceData was seen (a fresh, untrained model)."""
        if self._user_order is None:
            return None
        return {
            "format_version": np.int32(2),
            "user_order": _host(self._user_order).astype(np.int32),
            "item_order": _host(self._item_order).astype(np.int32),
            "dd_fp": np.asarray(self._dd_fp, np.int64),
        }

    def load_checkpoint_meta(self, meta: dict) -> None:
        """Adopt a restored checkpoint's id sidecar: evaluation, serving
        and export are id-correct without rebuilding the training
        DeviceData. ``meta=None`` (a checkpoint without a sidecar) warns
        when the restored state is trained."""
        if meta is None:
            if self.state.steps > 0:
                _log.warning(
                    "restored checkpoint has no id sidecar (format v1) — "
                    "evaluation/serving/export need the training "
                    "DeviceData (same bucketing parameters) passed to "
                    "initialize()/train_epoch() first to recover the id "
                    "permutation")
            return
        uo = np.asarray(meta["user_order"], np.int64)
        io = np.asarray(meta["item_order"], np.int64)
        if uo.size != self.num_users or io.size != self.num_items:
            raise ValueError(
                f"checkpoint id sidecar sized ({uo.size}, {io.size}) does "
                f"not match this model ({self.num_users}, "
                f"{self.num_items}) — wrong checkpoint for this dataset?")
        up = np.empty_like(uo)
        up[uo] = np.arange(uo.size)
        ip = np.empty_like(io)
        ip[io] = np.arange(io.size)
        put = lambda x: torch.from_numpy(x).to(self.device)
        self._user_order, self._user_perm = put(uo), put(up)
        self._item_order, self._item_perm = put(io), put(ip)
        self._dd_fp = tuple(int(x) for x in meta["dd_fp"])
        self._noted_dd_id = None
        self._fold_perm_cache = {}

    def _note_perms(self, dd: DeviceData) -> None:
        """Remember the training data's solver-order permutation; model
        tables live in solver-order id space and evaluation/serving data
        built in original id space is remapped through it. A trained
        state fed a DeviceData of the same id universe in another order
        is remapped into it; another id universe raises."""
        if self._noted_dd_id == id(dd):
            return
        self._check_mesh(dd)
        fp = _dd_fingerprint(dd)
        old = self._dd_fp
        if old is not None and old != fp and self.state.steps > 0:
            if old[:3] != fp[:3]:
                raise ValueError(
                    "train/initialize called with a DeviceData whose id "
                    f"universe {fp[:3]} (users, items, nnz) does not match "
                    f"the one this trained state came from {old[:3]}")
            _log.warning(
                "DeviceData solver order differs from the one this state "
                "was trained in (same id universe); remapping model tables "
                "into the new order")
            self._remap_state_to(dd)
        self._item_perm = dd.item_perm
        self._item_order = dd.item_order
        self._user_perm = dd.user_perm
        self._user_order = dd.user_order
        self._dd_fp = fp
        self._noted_dd_id = id(dd)
        self._fold_perm_cache = {}

    def _remap_state_to(self, dd: DeviceData) -> None:
        """Gather per-row state from the remembered solver order into
        ``dd``'s: new slot j holds original id dd.*_order[j], which sat
        at old slot old_perm[dd.*_order[j]]. The [dim, dim] leaves
        (Gramian, eigenbases) are permutation-invariant and stay."""
        gu = self._user_perm[dd.user_order]
        gi = self._item_perm[dd.item_order]
        s = self.state
        self.state = s.replace(
            user_emb=s.user_emb[gu], item_emb=s.item_emb[gi],
            user_loss=s.user_loss[gu], dual_weight=s.dual_weight[gu])

    def _permute_fold(self, fold: FoldInData,
                      cache: bool = True) -> FoldInData:
        """Remap a FoldInData's item ids (fold-in histories, exclusion
        lists, ground truth) into the model's solver-order item space.
        Cached per fold object; ``cache=False`` for transient folds.
        Identity when no permutation is known, with a one-time warning
        on a trained state (a checkpoint restored without its sidecar)."""
        perm = self._item_perm
        if perm is None:
            if self.state.steps > 0 and not self._perm_warned:
                self._perm_warned = True
                _log.warning(
                    "evaluating a trained state with no recorded id "
                    "permutation — if this state was restored from a "
                    "checkpoint, call initialize()/train_epoch() with "
                    "the DeviceData first so ids can be remapped "
                    "(docs/API.md 'Id spaces')")
            return fold
        if cache:
            hit = self._fold_perm_cache.get(id(fold))
            if hit is not None and hit[0] is fold:
                return hit[1]
        ni = self.num_items

        def ids(a):
            # pads are num_items ("never matches") and stay out of range
            return torch.where(a >= ni, a.clamp(max=ni),
                               perm[a.clamp(max=ni - 1)])

        out = dataclasses.replace(
            fold,
            # bucket col pads are 0 and masked; a plain remap suffices
            by_user=tuple(dataclasses.replace(b, col_ids=perm[b.col_ids])
                          for b in fold.by_user),
            excl=ids(fold.excl),
            gt=ids(fold.gt),
        )
        if cache:
            if len(self._fold_perm_cache) >= 4:
                self._fold_perm_cache.pop(next(iter(self._fold_perm_cache)))
            self._fold_perm_cache[id(fold)] = (fold, out)
        return out

    @f32_matmul()
    def train_epochs(self, dd: DeviceData, n: int) -> None:
        """Run ``n`` epochs without the per-epoch log lines."""
        self._note_perms(dd)
        for _ in range(n):
            with span("epoch", self.device, model=self.name,
                      steps=self.state.steps):
                self.state = self._epoch(self.state, dd)

    @f32_matmul()
    def train_epoch(self, dd: DeviceData) -> None:
        self._note_perms(dd)
        if self._stats_order == "pre":
            self._log_train_stats(dd)
        prev = self.state if self.print_residual_stats else None
        with span("epoch", self.device, model=self.name,
                  steps=self.state.steps):
            self.state = self._epoch(self.state, dd)
        if self._stats_order == "post":
            self._log_train_stats(dd)
        self._log_epoch_lines()
        self._log_var_stats()
        if prev is not None:
            s = self.state
            _log.info("U residual: %s, V residual: %s, z residual: %s",
                      float(torch.linalg.norm(s.user_emb - prev.user_emb)),
                      float(torch.linalg.norm(s.item_emb - prev.item_emb)),
                      float(torch.linalg.norm(
                          s.dual_weight - prev.dual_weight)))

    # ---- subclass hooks ---------------------------------------------------

    # When the model logs its loss decomposition: "pre" = at the top of
    # Train (safer family, safer2.h:267), "post" = after the sweeps.
    _stats_order = "pre"
    # True on the exact-solve models whose loss pass is phase-shifted to
    # the top of the next epoch: their loss-derived log lines describe
    # the pre-epoch model.
    _loss_lags_one_epoch = False

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        raise NotImplementedError

    def _reg_vectors(self, dd: DeviceData):
        """Per-row regularization values for the stats lines."""
        raise NotImplementedError

    def _log_epoch_lines(self) -> None:
        """Per-model end-of-epoch log lines (Weighted Loss / Xi / ...)."""

    def _log_train_stats(self, dd: DeviceData) -> None:
        if not self.print_train_stats:
            return
        from safer2_recommender_tpu_torch.models import stats
        from safer2_recommender_tpu_torch.utils.logging import Timer

        with Timer(self.device) as t:
            ur, ir = self._reg_vectors(dd)
            vals = stats.loss_decomposition(
                self.state.user_emb, self.state.item_emb,
                self.state.user_loss, dd, ur, ir, self.cfg.uobs_weight,
                loss_is_user_sum=(self._stats_order == "pre"))
        stats.log_loss_decomposition(vals, dd, t.ms)

    def _fold_in_prep(self, state: MFState):
        """The part of the fold-in that depends on the state alone: the
        eigenbasis of the frozen Gramian (``woodbury.maybe_eigh``, whose
        warm refresh reads the host once), the item table rotated into
        it, and what else a model solves with. Computed once per state
        snapshot, outside a CUDA graph."""
        return None

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """Return eval-user embeddings [fold.n_pad, dim]: the per-batch
        solve. ``prep`` is ``_fold_in_prep(state)``; None computes it."""
        raise NotImplementedError

    def _fold_in_split(self):
        """The bucket width at and below which this model's fold-in
        takes another route, or None: with the Woodbury path on (dim >=
        ``woodbury.MIN_DIM``, no CG), a bucket of width <= dim / 2 solves
        by Woodbury, a wider one directly. A fixed-shape batch
        (``serving.Server``) keeps the rows at and below it in a bucket
        of their own, as length bucketing does, so each row takes the
        route ``recommend`` gives it (and short rows skip the d x d
        systems)."""
        cfg = self.cfg
        if cfg.use_cg or cfg.dim < woodbury.MIN_DIM:
            return None
        return cfg.dim // 2

    # ---- evaluation and serving ---------------------------------------------

    @f32_matmul()
    def evaluate_dataset(
        self,
        fold: FoldInData,
        k_list: Sequence[int] = DEFAULT_K_LIST,
        alpha_list: Sequence[float] = DEFAULT_ALPHA_LIST,
    ) -> EvaluationResult:
        """Held-out evaluation: fold in fresh user embeddings from
        fold.by_user with items frozen, score the full catalog, mask
        history, compute Recall/NDCG. On a mesh each rank scores its
        block of rows and the per-user metrics are gathered."""
        self._check_mesh(fold)
        fold = self._permute_fold(fold)
        ue = self._fold_in(self.state, fold)
        lo, hi = mesh_lib.row_range(self.mesh, fold.n_pad)
        recall, ndcg = self._eval_metrics(ue[lo:hi], self.state.item_emb,
                                          fold, k_list=tuple(k_list))
        keep = fold.gt_len > 0
        if self.mesh is not None:
            k = len(k_list)
            got = mesh_lib.all_gather_rows(self.mesh, torch.cat(
                [recall, ndcg, keep[:, None].to(recall.dtype)], dim=1))
            recall, ndcg, keep = got[:, :k], got[:, k:2 * k], got[:, 2 * k] > 0
        keep = _host(keep)
        return EvaluationResult(
            k_list=tuple(k_list),
            alpha_list=tuple(alpha_list),
            recall=_host(recall)[keep],
            ndcg=_host(ndcg)[keep],
        )

    @f32_matmul()
    def recommend(self, histories, k: int = 10, approx: bool = False):
        """Top-k recommendations for new users.

        ``histories`` is a Dataset of (user, item) interactions (or a
        pre-built FoldInData); each user is folded in from their history
        with item embeddings frozen, the full catalog is scored in full
        f32 with history masked out, and the exact top-k item ids are
        returned (ties rank the lower solver-order id first).

        ``approx=True`` scores in TF32 on the card and ranks with
        ``torch.topk``, whose order among near-tied items is unspecified:
        the counterpart of the JAX package's default-precision scores and
        ``approx_max_k``, but not the TPU's approximate top-k itself
        (``torch.topk`` is exact on the scores it gets). On the CPU the
        scores stay f32. Evaluation always stays exact.

        Returns ``(user_ids [n], item_ids [n, k])`` numpy arrays, rows
        aligned to the distinct users of ``histories``. On a mesh every
        rank returns all of them (each ranks its block of rows).
        """
        if isinstance(histories, Dataset):
            users = np.unique(histories.user_ids)
            empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
            fold = FoldInData.build(histories, empty,
                                    num_items=self.num_items,
                                    device=self.device, dim=self.cfg.dim,
                                    mesh=self.mesh)
        else:
            fold = histories
            users = np.arange(fold.n_eval)
        self._check_mesh(fold)
        fold = self._permute_fold(fold, cache=False)
        ue = self._fold_in(self.state, fold)
        lo, hi = mesh_lib.row_range(self.mesh, fold.n_pad)
        ids = self._recommend_ids(ue[lo:hi], self.state.item_emb, fold.excl,
                                  k=k, approx=approx)
        if self.mesh is not None:
            ids = mesh_lib.all_gather_rows(self.mesh, ids)
        if self._item_order is not None:
            # decode solver-order item ids back to catalog ids
            ids = self._item_order[ids]
        return users, _host(ids)[: users.size]

    def _recommend_ids(self, ue: torch.Tensor, item_emb: torch.Tensor,
                       excl: torch.Tensor, *, k: int,
                       approx: bool = False) -> torch.Tensor:
        """Chunked scoring + top-k (bounds the [chunk, num_items] score
        matrix) of ``ue``, this rank's block of rows (all of them without
        a mesh); full f32, or TF32 on the card for ``approx``."""
        chunk = self._rank_chunk(ue.shape[0])
        out = []
        for lo in range(0, ue.shape[0], chunk):
            with matmul_precision("high" if approx else "highest"):
                scores = ue[lo:lo + chunk] @ item_emb.T
            out.append(topk_ids(scores, excl[lo:lo + chunk], k,
                                approx=approx))
        return torch.cat(out)

    def _eval_chunk(self, n_pad: int) -> int:
        """Largest divisor of the fold's padded row count that fits the
        configured chunk (bounds the [chunk, num_items] score matrix). On
        a mesh the chunk is a multiple of the shard count, so it splits
        evenly over the ranks (``n_pad`` is one already)."""
        step = mesh_lib.num_shards(self.mesh)
        chunk = min(self.cfg.eval_chunk, n_pad)
        chunk = max(chunk - chunk % step, step)
        while n_pad % chunk:
            chunk -= step
        return chunk

    def _rank_chunk(self, rows: int) -> int:
        """One rank's share of ``_eval_chunk`` for its block of ``rows``
        rows (of ``rows x shards`` in all)."""
        s = mesh_lib.num_shards(self.mesh)
        return self._eval_chunk(rows * s) // s

    def _eval_metrics(self, ue: torch.Tensor, item_emb: torch.Tensor,
                      fold: FoldInData, *, k_list: Tuple[int, ...]):
        """Per-row Recall/NDCG of ``ue``, this rank's block of rows, against
        the fold's rows (the rank's on a mesh)."""
        chunk = self._rank_chunk(ue.shape[0])
        rec, ndcg = [], []
        for lo in range(0, ue.shape[0], chunk):
            hi = lo + chunk
            # full f32 scoring like the reference's (ials.h:181-183):
            # near-tied items must not reorder inside the top-k
            r, n = topk_metrics(ue[lo:hi] @ item_emb.T, fold.excl[lo:hi],
                                fold.gt[lo:hi], fold.gt_len[lo:hi], k_list)
            rec.append(r)
            ndcg.append(n)
        return torch.cat(rec), torch.cat(ndcg)

    # ---- logging ------------------------------------------------------------

    def _log_var_stats(self) -> None:
        if not self.print_var_stats:
            return
        self._note_loss_phase()
        vals = np.sort(-_host(self.state.user_loss))
        # Q = n * alpha stays a FLOAT (ials.h:212-218): the sum runs over
        # floor(Q)+1 elements but the divisor is Q itself; alpha == 1.0
        # is clamped instead of reading past the end.
        qf = len(vals) * self.cfg.alpha
        q = min(int(qf), len(vals) - 1)
        var = -vals[q]
        cvar = -vals[: q + 1].sum() / (qf if qf > 0 else 1.0)
        _log.info("VaR: %s CVaR: %s", var, cvar)
        dw = _host(self.state.dual_weight)
        _log.info("Min: %.3f, Mean: %.3f, Max: %.3f",
                  dw.min(), dw.mean(), dw.max())

    def _log_weighted_loss(self) -> None:
        self._note_loss_phase()
        wl = float(torch.mean(self.state.dual_weight * self.state.user_loss))
        _log.info("Weighted Loss: %s", wl)

    def _note_loss_phase(self) -> None:
        """One-time note that the exact-solve models' loss-derived log
        lines describe the PRE-epoch model (the loss pass is
        phase-shifted to the top of the next epoch)."""
        if self._loss_lags_one_epoch and not getattr(
                self, "_loss_phase_noted", False):
            self._loss_phase_noted = True
            _log.info(
                "note: loss-derived stats lag one epoch (they describe "
                "the pre-epoch model; identical math, shifted print — "
                "PARITY.md section 5)")


class SaferFamilyMixin:
    """Shared SAFER-family machinery: the two regularizer formulas
    (reference safer2.h:418-432, erm_mf.h:384-395) every family member
    (erm_mf, cvar_mf, safer2, safer2pp) uses, plus the weighted
    exact-solve sweeps and one-shot fold-in that erm_mf and safer2 share
    (cvar_mf overrides with gradient steps and a closed-form eval;
    safer2pp with blockwise sweeps)."""

    def _user_reg(self) -> float:
        # reference safer2.h:418-421
        return self.cfg.l2_reg * (1.0 + self.cfg.uobs_weight
                                  * self.num_items)

    def _item_reg(self, item_reg_vec: torch.Tensor,
                  row_ids: torch.Tensor) -> torch.Tensor:
        # reference safer2.h:426-432; gap/pad ids clamp to the last stat
        stat = item_reg_vec[row_ids.clamp(max=item_reg_vec.shape[0] - 1)]
        return self.cfg.l2_reg * (
            stat + self.cfg.alpha * self.cfg.uobs_weight * self.num_users)

    def _reg_vectors(self, dd: DeviceData):
        ur = torch.full((dd.num_users,), self._user_reg(),
                        device=dd.device)
        ir = self._item_reg(dd.item_reg,
                            torch.arange(dd.num_items, device=dd.device))
        return ur, ir

    def _init_losses(self, dd: DeviceData, **kw) -> None:
        """The SAFER family's Initialize: the per-user (halved) losses of
        the initial tables, so the pre-training state is inspectable;
        ``kw`` are further state fields to set."""
        self._start(dd)
        s = self.state
        loss = common.user_losses(s.user_emb, s.item_emb, s.item_gramian,
                                  dd.by_user, dd.num_users,
                                  self.cfg.uobs_weight, halve=True,
                                  dtype=self.asm_dtype)
        self.state = s.replace(user_loss=loss, **kw)

    @staticmethod
    def _norm_dual(dd: DeviceData, dual: torch.Tensor) -> torch.Tensor:
        """z_u / |H_u|, the item side's per-slot weights (0 for absent
        users)."""
        return torch.where(dd.user_hist_size > 0,
                           dual / dd.user_hist_size.clamp(min=1.0),
                           torch.zeros_like(dual))

    def _step_u(self, ue, item_emb, gramian, buckets, dual, pre_list=None,
                q_prev=None, eig=None, t_rot=None):
        """Weighted mean-normalized exact U-solves (reference
        safer2.h:104-163 / erm_mf.h:91-151). ``eig`` is the Gramian's
        (Q, lam); None computes it (``woodbury.maybe_eigh``, warm from
        ``q_prev``). ``t_rot`` is the item table rotated into it, or
        None (``common.solve_sweep`` rotates it). Returns (new table,
        new eigenbasis or None)."""
        cfg = self.cfg
        reg = self._user_reg()
        if eig is None:
            eig = woodbury.maybe_eigh(gramian, cfg.dim, use_cg=cfg.use_cg,
                                      q_prev=q_prev,
                                      refresh_tol=cfg.eig_refresh_tol)
        item_emb = assemble.cast(item_emb, self.asm_dtype)  # once a sweep

        def params_fn(b, pre, other):
            w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
            return common.params_weighted_mean(
                other, b, torch.full((b.n_rows,), reg, device=ue.device),
                cfg.uobs_weight, w, dtype=self.asm_dtype, pre=pre)

        out = common.solve_sweep(ue, buckets, params_fn, gramian,
                                 table_other=item_emb, eig=eig, t_rot=t_rot,
                                 use_cg=cfg.use_cg,
                                 cg_tol=cfg.cg_error_tolerance,
                                 cg_iters=cfg.cg_max_iterations,
                                 pre_list=pre_list)
        return out, (eig[0] if eig is not None else None)

    def _step_v(self, v, user_emb, dd: DeviceData, dual, q_prev=None):
        """Dual-weighted exact V-solves (reference safer2.h:166-221 /
        erm_mf.h:153-210). The weighted Gramian U^T diag(z) U spans the
        full table incl. id gaps and is recomputed every call. Returns
        (new table, new eigenbasis or None)."""
        cfg = self.cfg
        w_gram = user_emb.T @ (user_emb * dual[:, None])
        norm_dual = self._norm_dual(dd, dual)
        eig = woodbury.maybe_eigh(w_gram, cfg.dim, use_cg=cfg.use_cg,
                                  q_prev=q_prev,
                                  refresh_tol=cfg.eig_refresh_tol)
        user_emb = assemble.cast(user_emb, self.asm_dtype)  # once a sweep

        def params_fn(b, pre, other):
            reg = self._item_reg(dd.item_reg, b.row_ids)
            return common.params_weighted_item(
                other, b, reg, cfg.uobs_weight, norm_dual,
                dtype=self.asm_dtype)

        out = common.solve_sweep(v, dd.by_item, params_fn, w_gram,
                                 table_other=user_emb, eig=eig,
                                 use_cg=cfg.use_cg,
                                 cg_tol=cfg.cg_error_tolerance,
                                 cg_iters=cfg.cg_max_iterations)
        return out, (eig[0] if eig is not None else None)

    def _fold_in_prep(self, state: MFState):
        """``(eig, t_rot)``: (Q, lam) of the frozen item Gramian, warm
        from the carried basis, or None on the direct path, and the item
        table rotated into it (``common.rotated_items``)."""
        cfg = self.cfg
        eig = woodbury.maybe_eigh(state.item_gramian, cfg.dim,
                                  use_cg=cfg.use_cg, q_prev=state.eig_qu,
                                  refresh_tol=cfg.eig_refresh_tol)
        return eig, common.rotated_items(eig, state.item_emb, self.asm_dtype)

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """StepU with weight 1.0 (reference safer2.h:246-252,
        erm_mf.h:234-244)."""
        ue = torch.zeros((fold.n_pad, self.cfg.dim), device=self.device)
        ones = torch.ones((fold.n_pad,), device=self.device)
        eig, t_rot = self._fold_in_prep(state) if prep is None else prep
        return self._step_u(ue, state.item_emb, state.item_gramian,
                            fold.by_user, ones, eig=eig, t_rot=t_rot)[0]
