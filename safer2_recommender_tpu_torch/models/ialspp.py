"""iALS++: block coordinate descent over embedding sub-blocks (the
counterpart of ``safer2_recommender_tpu/models/ialspp.py``).

Delta solves over blocks of size ``block_size``:

  A = uobs * G_loc + reg * I + sum_h v_loc v_loc^T
  rhs = sum_h v_loc (pred - 1) + uobs * G_lg @ x + reg * x_loc
  x_loc <- x_loc - A^-1 rhs                        (ialspp.h:85-145)

Train epoch = full U block sweep, then full V block sweep: the frozen
reordering of the reference's per-block U/V interleave
(ialspp.h:208-261; ``models/common.py::block_sweep_frozen`` has the
argument). The reference's flat prediction cache (ialspp.h:399-406,
:469-517) becomes slab-local incremental predictions. Held-out
evaluation = ``eval_fold_in_epochs`` (8) blockwise fold-in sweeps
(ialspp.h:149-206) that share one slab gather.

``Config.block_interleaved`` with ``dim % block_size == 0`` trains in
the reference's own order instead (``common.block_sweep_interleaved``),
the loss coming from the carried predictions at the end of the epoch.
"""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import (MFState, Recommender,
                                                      _log)
from safer2_recommender_tpu_torch.models.ials import ials_reg_vectors
from safer2_recommender_tpu_torch.ops import woodbury

def interleaved(cfg) -> bool:
    """Does the reference-order sweep engage (``block_interleaved`` with
    ``dim % block_size == 0``)?"""
    return cfg.block_interleaved and cfg.dim % cfg.block_size == 0


def _warn_interleaved_fallback(model) -> None:
    """One-time runtime notice when block_interleaved cannot engage
    (dim % block_size != 0): the user asked for the reference-order
    fidelity trajectory but is getting the fast frozen sweep."""
    if model.cfg.block_interleaved and (
            model.cfg.dim % model.cfg.block_size) and not getattr(
            model, "_interleaved_fallback_warned", False):
        model._interleaved_fallback_warned = True
        _log.warning(
            "block_interleaved requested but dim %d is not a multiple of "
            "block_size %d — falling back to the frozen (fast) sweep; "
            "the reference-order fidelity trajectory needs "
            "dim %% block_size == 0",
            model.cfg.dim, model.cfg.block_size)


def fold_in_prep(model, state: MFState):
    """The state-only part of the ++ models' fold-in: ``(eig, block_eig,
    t_rot)``.

    ``eig`` is (Q, lam) of the item Gramian, or None: the fold-in follows
    the training mode, blockwise sweeps under ``block_interleaved``,
    collapsed to one exact solve (the full-dim Woodbury) by default.
    ``block_eig`` is the diagonal blocks' eigendecomposition for the
    block-level Woodbury (``common.block_eigh``) where it can engage.
    ``t_rot`` is the item table rotated into ``eig``
    (``common.rotated_items``), or None."""
    cfg = model.cfg
    eig = None
    if not cfg.block_interleaved:
        eig = woodbury.maybe_eigh(state.item_gramian, cfg.dim, use_cg=False,
                                  q_prev=state.eig_qu,
                                  refresh_tol=cfg.eig_refresh_tol)
    block_eig = None
    if eig is None and cfg.dim % cfg.block_size == 0 \
            and cfg.block_size >= 16:
        block_eig = common.block_eigh(state.item_gramian, cfg.block_size)
    return eig, block_eig, common.rotated_items(eig, state.item_emb,
                                                model.asm_dtype)


def fold_in_split(model):
    """The width at and below which a bucket folds in by another route
    (``common.block_sweep_frozen``), or None. Where ``eig`` is on, a
    bucket of width <= dim / 2 folds in by one exact full-dim Woodbury
    solve and a wider one by the blockwise sweeps: two results, not two
    roundings. Otherwise, where ``block_eig`` is on, a bucket of width
    <= block_size / 2 solves each block by the block-level Woodbury and
    a wider one directly. The Server splits its batches here to equal
    ``recommend``."""
    cfg = model.cfg
    if not cfg.block_interleaved and cfg.dim >= woodbury.MIN_DIM:
        return cfg.dim // 2
    if cfg.dim % cfg.block_size == 0 and cfg.block_size >= 16:
        return cfg.block_size // 2
    return None


class IALSpp(Recommender):
    name = "ialspp"
    _stats_order = "post"

    @property
    def _loss_lags_one_epoch(self) -> bool:
        # in interleaved mode the stored loss is computed at the end of
        # the epoch from the carried predictions: it does not lag
        return not interleaved(self.cfg)

    def _reg_vectors(self, dd: DeviceData):
        return ials_reg_vectors(self.cfg, dd)

    def _spec_fn(self, num_choices: int):
        """Freq-scaled regularizer, unweighted history term
        (reference ialspp.h:85-145 + RegularizationValue)."""
        cfg = self.cfg

        def spec_fn(b):
            reg = common.ials_reg(b.length, num_choices, cfg.l2_reg,
                                  cfg.l2_reg_exp, cfg.uobs_weight)
            return common.BlockSpec(
                cg=torch.full((b.n_rows,), cfg.uobs_weight,
                              device=self.device),
                reg=reg)
        return spec_fn

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        cfg = self.cfg
        _warn_interleaved_fallback(self)
        if interleaved(cfg):
            # reference order (ialspp.h:208-261): per block, Step(user)
            # then Step(item); the loss from the carried predictions, /|H|
            # as the reference's ComputeUserLoss divides
            u, v, preds_u = common.block_sweep_interleaved(
                state.user_emb, state.item_emb, dd.by_user, dd.by_item,
                self._spec_fn(dd.num_items), self._spec_fn(dd.num_users),
                bs=cfg.block_size, dtype=self.asm_dtype)
            gram = v.T @ v
            loss = common.losses_from_preds(
                preds_u, dd.by_user, u, gram, dd.num_users,
                cfg.uobs_weight, mean=True, halve=False)
            return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                                 user_loss=loss, steps=state.steps + 1)
        # The reference's end-of-epoch ComputeUserLoss (stats-only) runs
        # at the top of the next epoch, where it shares the user sweep's
        # slab gathers (as in IALS._epoch); the stored user_loss
        # describes the carried (pre-epoch) model.
        loss, pre = common.gather_and_losses(
            state.item_emb, dd.by_user, state.user_emb,
            state.item_gramian, dd.num_users, cfg.uobs_weight, halve=False,
            dtype=self.asm_dtype)
        # (Q, lam) of each sweep's frozen Gramian upgrades Woodbury-
        # eligible buckets to one full-dim block; warm-started from the
        # previous epoch's basis.
        eig_u = woodbury.maybe_eigh(state.item_gramian, cfg.dim,
                                    use_cg=False, q_prev=state.eig_qu,
                                    refresh_tol=cfg.eig_refresh_tol)
        u = common.block_sweep_frozen(
            state.user_emb, state.item_emb, dd.by_user,
            state.item_gramian, self._spec_fn(dd.num_items),
            bs=cfg.block_size, dtype=self.asm_dtype, eig=eig_u,
            pre_list=pre)
        del pre
        gram_u = u.T @ u
        eig_v = woodbury.maybe_eigh(gram_u, cfg.dim, use_cg=False,
                                    q_prev=state.eig_qv,
                                    refresh_tol=cfg.eig_refresh_tol)
        v = common.block_sweep_frozen(
            state.item_emb, u, dd.by_item, gram_u,
            self._spec_fn(dd.num_users), bs=cfg.block_size,
            dtype=self.asm_dtype, eig=eig_v)
        return state.replace(user_emb=u, item_emb=v, item_gramian=v.T @ v,
                             user_loss=loss, steps=state.steps + 1,
                             eig_qu=eig_u[0] if eig_u else state.eig_qu,
                             eig_qv=eig_v[0] if eig_v else state.eig_qv)

    def _fold_in_prep(self, state: MFState):
        return fold_in_prep(self, state)

    def _fold_in_split(self):
        return fold_in_split(self)

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """``eval_fold_in_epochs`` blockwise fold-in sweeps (reference
        ialspp.h:149-206); the item table is frozen throughout, so one
        slab gather per bucket serves every block solve of every sweep."""
        ue = torch.zeros((fold.n_pad, self.cfg.dim), device=self.device)
        eig, block_eig, t_rot = prep or fold_in_prep(self, state)
        return common.block_sweep_frozen(
            ue, state.item_emb, fold.by_user, state.item_gramian,
            self._spec_fn(self.num_items), bs=self.cfg.block_size,
            n_sweeps=self.cfg.eval_fold_in_epochs, dtype=self.asm_dtype,
            eig=eig, block_eig=block_eig, t_rot=t_rot)
