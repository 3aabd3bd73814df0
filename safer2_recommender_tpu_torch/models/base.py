"""Recommender base class: state, training loop, evaluation and serving
(the counterpart of ``safer2_recommender_tpu/models/base.py``).

Evaluation of a held-out dataset folds in fresh user embeddings with
the item table frozen, scores the whole catalog in chunks and ranks it
with history masked out; serving (``recommend``) is the same
computation returning the top-k ids.
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
from safer2_recommender_tpu_torch.ops import woodbury
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       resolve_device)
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)

BF16_NOT_PORTED = (
    "compute_dtype='bf16': the port assembles in float32 until an "
    "f32-vs-bf16 quality A/B on the GPU exists (ROADMAP Queue 1 item 8)")


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
                 device=DEFAULT_DEVICE):
        if cfg.compute_dtype not in ("auto", "f32"):
            raise NotImplementedError(BF16_NOT_PORTED)
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items
        self.device = resolve_device(device)
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

    def initialize(self, dd: DeviceData) -> None:
        """Pre-training warm start; overridden by the SAFER family."""
        self._note_perms(dd)

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
                    "permutation: call initialize()/train_epoch() with the "
                    "training DeviceData first")
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

    def _note_perms(self, dd: DeviceData) -> None:
        """Remember the training data's solver-order permutation; model
        tables live in solver-order id space and evaluation/serving data
        built in original id space is remapped through it. A trained
        state fed a DeviceData of the same id universe in another order
        is remapped into it; another id universe raises."""
        if self._noted_dd_id == id(dd):
            return
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
        Cached per fold object; ``cache=False`` for transient folds."""
        perm = self._item_perm
        if perm is None:
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

    def train_epochs(self, dd: DeviceData, n: int) -> None:
        """Run ``n`` epochs without the per-epoch log lines."""
        self._note_perms(dd)
        for _ in range(n):
            self.state = self._epoch(self.state, dd)

    def train_epoch(self, dd: DeviceData) -> None:
        self._note_perms(dd)
        if self._stats_order == "pre":
            self._log_train_stats(dd)
        prev = self.state if self.print_residual_stats else None
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

    def _fold_in(self, state: MFState, fold: FoldInData) -> torch.Tensor:
        """Return eval-user embeddings [fold.n_pad, dim]."""
        raise NotImplementedError

    # ---- evaluation and serving ---------------------------------------------

    def evaluate_dataset(
        self,
        fold: FoldInData,
        k_list: Sequence[int] = DEFAULT_K_LIST,
        alpha_list: Sequence[float] = DEFAULT_ALPHA_LIST,
    ) -> EvaluationResult:
        """Held-out evaluation: fold in fresh user embeddings from
        fold.by_user with items frozen, score the full catalog, mask
        history, compute Recall/NDCG."""
        fold = self._permute_fold(fold)
        ue = self._fold_in(self.state, fold)
        recall, ndcg = self._eval_metrics(ue, self.state.item_emb, fold,
                                          k_list=tuple(k_list))
        keep = _host(fold.gt_len) > 0
        return EvaluationResult(
            k_list=tuple(k_list),
            alpha_list=tuple(alpha_list),
            recall=_host(recall)[keep],
            ndcg=_host(ndcg)[keep],
        )

    def recommend(self, histories, k: int = 10, approx: bool = False):
        """Top-k recommendations for new users.

        ``histories`` is a Dataset of (user, item) interactions (or a
        pre-built FoldInData); each user is folded in from their history
        with item embeddings frozen, the full catalog is scored in full
        f32 with history masked out, and the exact top-k item ids are
        returned (ties rank the lower solver-order id first).

        Returns ``(user_ids [n], item_ids [n, k])`` numpy arrays, rows
        aligned to the distinct users of ``histories``.
        """
        if approx:
            raise NotImplementedError(
                "approx=True: approximate top-k is not ported to PyTorch "
                "yet (ROADMAP Queue 1 item 15)")
        if isinstance(histories, Dataset):
            users = np.unique(histories.user_ids)
            empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
            fold = FoldInData.build(histories, empty,
                                    num_items=self.num_items,
                                    device=self.device, dim=self.cfg.dim)
        else:
            fold = histories
            users = np.arange(fold.n_eval)
        fold = self._permute_fold(fold, cache=False)
        ue = self._fold_in(self.state, fold)
        ids = self._recommend_ids(ue, self.state.item_emb, fold.excl, k=k)
        if self._item_order is not None:
            # decode solver-order item ids back to catalog ids
            ids = self._item_order[ids]
        return users, _host(ids)[: users.size]

    def _recommend_ids(self, ue: torch.Tensor, item_emb: torch.Tensor,
                       excl: torch.Tensor, *, k: int) -> torch.Tensor:
        chunk = self._eval_chunk(ue.shape[0])
        out = [topk_ids(ue[lo:lo + chunk] @ item_emb.T,
                        excl[lo:lo + chunk], k)
               for lo in range(0, ue.shape[0], chunk)]
        return torch.cat(out)

    def _eval_chunk(self, n_pad: int) -> int:
        """Largest divisor of the fold's padded row count that fits the
        configured chunk (bounds the [chunk, num_items] score matrix)."""
        chunk = max(min(self.cfg.eval_chunk, n_pad), 1)
        while n_pad % chunk:
            chunk -= 1
        return chunk

    def _eval_metrics(self, ue: torch.Tensor, item_emb: torch.Tensor,
                      fold: FoldInData, *, k_list: Tuple[int, ...]):
        chunk = self._eval_chunk(fold.n_pad)
        rec, ndcg = [], []
        for lo in range(0, fold.n_pad, chunk):
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
    (reference safer2.h:418-432), the weighted exact-solve sweeps and
    the one-shot fold-in."""

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

    def _step_u(self, ue, item_emb, gramian, buckets, dual, pre_list=None,
                q_prev=None):
        """Weighted mean-normalized exact U-solves (reference
        safer2.h:104-163). Returns (new table, new eigenbasis or None)."""
        cfg = self.cfg
        reg = self._user_reg()
        eig = woodbury.maybe_eigh(gramian, cfg.dim, use_cg=cfg.use_cg,
                                  q_prev=q_prev,
                                  refresh_tol=cfg.eig_refresh_tol)

        def params_fn(b, pre=None):
            w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
            return common.params_weighted_mean(
                item_emb, b, torch.full((b.n_rows,), reg, device=ue.device),
                cfg.uobs_weight, w, pre=pre)

        out = common.solve_sweep(ue, buckets, params_fn, gramian, eig=eig,
                                 use_cg=cfg.use_cg, pre_list=pre_list)
        return out, (eig[0] if eig is not None else None)

    def _step_v(self, v, user_emb, dd: DeviceData, dual, q_prev=None):
        """Dual-weighted exact V-solves (reference safer2.h:166-221). The
        weighted Gramian U^T diag(z) U spans the full table incl. id
        gaps and is recomputed every call. Returns (new table, new
        eigenbasis or None)."""
        cfg = self.cfg
        w_gram = user_emb.T @ (user_emb * dual[:, None])
        norm_dual = torch.where(
            dd.user_hist_size > 0,
            dual / dd.user_hist_size.clamp(min=1.0),
            torch.zeros_like(dual))
        eig = woodbury.maybe_eigh(w_gram, cfg.dim, use_cg=cfg.use_cg,
                                  q_prev=q_prev,
                                  refresh_tol=cfg.eig_refresh_tol)

        def params_fn(b, pre=None):
            reg = self._item_reg(dd.item_reg, b.row_ids)
            return common.params_weighted_item(
                user_emb, b, reg, cfg.uobs_weight, norm_dual)

        out = common.solve_sweep(v, dd.by_item, params_fn, w_gram, eig=eig,
                                 use_cg=cfg.use_cg)
        return out, (eig[0] if eig is not None else None)

    def _fold_in(self, state: MFState, fold: FoldInData) -> torch.Tensor:
        """StepU with weight 1.0 (reference safer2.h:246-252)."""
        ue = torch.zeros((fold.n_pad, self.cfg.dim), device=self.device)
        ones = torch.ones((fold.n_pad,), device=self.device)
        return self._step_u(ue, state.item_emb, state.item_gramian,
                            fold.by_user, ones, q_prev=state.eig_qu)[0]
