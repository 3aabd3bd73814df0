"""SAFER2++: SAFER2 fused with iALS++-style block coordinate descent
(the counterpart of ``safer2_recommender_tpu/models/safer2pp.py``).

  user block : A = w (sum v_loc v_loc^T / |H| + uobs G_loc) + reg I
               rhs = (w/|H|) sum v_loc (pred-1) + w uobs G_lg u + reg u_loc
               (safer2pp.h:97-159)
  item block : raw-dual-weighted Gramian slices (safer2pp.h:532-544),
               wt = z/|H_u| residual rhs (safer2pp.h:161-216)
  z-step     : vectorized over the whole dual vector (safer2pp.h:839-862;
               unlike SAFER2, id gaps are updated too)
  train      : pd x {z, U block sweep, V block sweep}, V^T V, loss, xi
               (safer2pp.h:288-355; the reference interleaves U/V per
               block, ``models/common.py::block_sweep_frozen`` has the
               reordering; ``Config.block_interleaved`` keeps the
               reference's order, ``common.block_sweep_interleaved``)
  eval       : ``eval_fold_in_epochs`` (8) blockwise fold-in sweeps with
               weight 1 (safer2pp.h:220-286)

The reference's flat prediction/residual cache (safer2pp.h:469-517,
:504-508) becomes slab-local incremental predictions inside each
bucket's sweep; the per-user loss (safer2pp.h:611-652) is recomputed
from the live tables, or, in the reference's order, read from the
carried predictions.
"""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import MFState
from safer2_recommender_tpu_torch.models.ialspp import (
    _warn_interleaved_fallback, fold_in_prep, fold_in_split, interleaved)
from safer2_recommender_tpu_torch.models.safer2 import SAFER2
from safer2_recommender_tpu_torch.ops import smoothing, woodbury
from safer2_recommender_tpu_torch.utils.logging import span


class SAFER2pp(SAFER2):
    """Shares SAFER2's log lines, xi warm start and ``initialize``."""

    name = "safer2pp"

    @property
    def _loss_lags_one_epoch(self) -> bool:
        # in interleaved mode the stored loss is computed at the end of
        # the iteration from the carried predictions: it does not lag
        return not interleaved(self.cfg)

    def _spec_u(self, dual: torch.Tensor):
        """User-side coefficients (reference safer2pp.h:97-159):
        ch = w/|H|, cg = w*uobs, scalar user reg (safer2.h:418-421)."""
        cfg = self.cfg
        reg = self._user_reg()

        def spec_fn(b):
            w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
            return common.BlockSpec(
                ch=w / common.safe_len(b),
                cg=cfg.uobs_weight * w,
                reg=torch.full((b.n_rows,), reg, device=self.device))
        return spec_fn

    def _spec_v(self, dd: DeviceData):
        """Item-side coefficients (reference safer2pp.h:161-216): the
        z/|H| slot weights ride ``extra_vec``; per-item reg statistic."""
        cfg = self.cfg

        def spec_fn(b):
            return common.BlockSpec(
                cg=torch.full((b.n_rows,), cfg.uobs_weight,
                              device=self.device),
                reg=self._item_reg(dd.item_reg, b.row_ids))
        return spec_fn

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        """One Train call, phase-shifted exactly like ``SAFER2._epoch``.

        Reference epoch = predict; pd x {z, U blocks, V blocks, gram,
        loss}; xi (safer2pp.h:288-355) with Initialize pre-computing
        loss and xi(warm=mean) (safer2pp.h:885-912). Nothing changes
        (u, v) between one epoch's trailing {gram, loss, xi} and the
        next epoch's leading z, so the same update sequence runs as
        pd x {loss, [xi at t=0], z, U, V, gram}, and the loss pass shares
        its [N, L, d] slab gathers with the U sweep."""
        cfg = self.cfg
        u, v = state.user_emb, state.item_emb
        loss, dual = state.user_loss, state.dual_weight
        gram, xi = state.item_gramian, state.xi
        eq_u, eq_v = state.eig_qu, state.eig_qv
        _warn_interleaved_fallback(self)
        if cfg.pd_iterations == 0:
            # trailing ComputeXi still runs on the carried loss
            # (safer2pp.h:352-354)
            xi = self._xi(loss, state, xi)
        if interleaved(cfg):
            # reference order (safer2pp.h:303-319): per block, StepU then
            # StepV against live Gramians; the carried predictions give
            # both the residuals and the end-of-iteration loss, so xi at
            # t = 0 reads the carried loss
            for t in range(cfg.pd_iterations):
                if t == 0:
                    xi = self._xi(loss, state, xi)
                dual = smoothing.dual_weight(loss, xi, cfg.bandwidth,
                                             cfg.use_epanechnikov)
                u, v, preds_u = common.block_sweep_interleaved(
                    u, v, dd.by_user, dd.by_item, self._spec_u(dual),
                    self._spec_v(dd), bs=cfg.block_size,
                    dtype=self.asm_dtype,
                    extra_vec_v=self._norm_dual(dd, dual), g_weight_v=dual)
                gram = v.T @ v
                loss = common.losses_from_preds(
                    preds_u, dd.by_user, u, gram, dd.num_users,
                    cfg.uobs_weight, mean=True, halve=True)
            return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                                 user_loss=loss, dual_weight=dual, xi=xi,
                                 steps=state.steps + 1)
        dev = self.device
        for t in range(cfg.pd_iterations):
            with span("epoch.loss", dev):
                loss, pre = common.gather_and_losses(
                    v, dd.by_user, u, gram, dd.num_users, cfg.uobs_weight,
                    halve=True, dtype=self.asm_dtype)
            if t == 0:
                xi = self._xi(loss, state, xi)
            # vectorized z-step over the full dual vector
            # (safer2pp.h:839-862)
            with span("epoch.z", dev):
                dual = smoothing.dual_weight(loss, xi, cfg.bandwidth,
                                             cfg.use_epanechnikov)
            # (Q, lam) of each sweep's frozen Gramian: Woodbury-eligible
            # buckets run one full-dim block (block_sweep_frozen)
            with span("epoch.u_sweep", dev):
                eig_u = woodbury.maybe_eigh(gram, cfg.dim, use_cg=False,
                                            q_prev=eq_u,
                                            refresh_tol=cfg.eig_refresh_tol)
                u = common.block_sweep_frozen(
                    u, v, dd.by_user, gram, self._spec_u(dual),
                    bs=cfg.block_size, dtype=self.asm_dtype, eig=eig_u,
                    pre_list=pre)
            del pre
            with span("epoch.v_sweep", dev):
                # raw-dual-weighted user Gramian: every V block's
                # G_loc_w / G_lg_w (safer2pp.h:532-544) is a slice of it
                g_w = u.T @ (u * dual[:, None])
                eig_v = woodbury.maybe_eigh(g_w, cfg.dim, use_cg=False,
                                            q_prev=eq_v,
                                            refresh_tol=cfg.eig_refresh_tol)
                v = common.block_sweep_frozen(
                    v, u, dd.by_item, g_w, self._spec_v(dd),
                    bs=cfg.block_size, dtype=self.asm_dtype,
                    extra_vec=self._norm_dual(dd, dual), eig=eig_v)
            if eig_u is not None:
                eq_u, eq_v = eig_u[0], eig_v[0]
            with span("epoch.gram", dev):
                gram = v.T @ v
        return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                             user_loss=loss, dual_weight=dual, xi=xi,
                             steps=state.steps + 1, eig_qu=eq_u,
                             eig_qv=eq_v)

    def _fold_in_prep(self, state: MFState):
        return fold_in_prep(self, state)

    def _fold_in_split(self):
        return fold_in_split(self)

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """``eval_fold_in_epochs`` blockwise fold-in sweeps with weight 1
        (reference safer2pp.h:220-286); the frozen item table means one
        slab gather per bucket serves every sweep."""
        ue = torch.zeros((fold.n_pad, self.cfg.dim), device=self.device)
        ones = torch.ones((fold.n_pad,), device=self.device)
        eig, block_eig, t_rot = prep or fold_in_prep(self, state)
        return common.block_sweep_frozen(
            ue, state.item_emb, fold.by_user, state.item_gramian,
            self._spec_u(ones), bs=self.cfg.block_size,
            n_sweeps=self.cfg.eval_fold_in_epochs, dtype=self.asm_dtype,
            eig=eig, block_eig=block_eig, t_rot=t_rot)
