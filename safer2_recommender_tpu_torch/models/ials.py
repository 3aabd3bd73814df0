"""iALS: implicit alternating least squares (the counterpart of
``safer2_recommender_tpu/models/ials.py``).

Exact alternating solves with the frequency-scaled regularization
reg*(|H| + uobs*n)^exp (reference ials.h:310-315) and a Gramian-based
unobserved term. One epoch = user sweep, item sweep, loss computation
(ials.h:187-224). iALS's per-user loss has no /2, unlike the other five
models (ials.h:70-86).
"""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import MFState, Recommender
from safer2_recommender_tpu_torch.ops import assemble, woodbury


def ials_reg_vectors(cfg, dd: DeviceData):
    """Per-user and per-item regularization values of the iALS family
    (for the stats lines)."""
    ur = common.ials_reg(dd.user_hist_size, dd.num_items, cfg.l2_reg,
                         cfg.l2_reg_exp, cfg.uobs_weight)
    ir = common.ials_reg(dd.item_hist_size, dd.num_users, cfg.l2_reg,
                         cfg.l2_reg_exp, cfg.uobs_weight)
    return ur, ir


class IALS(Recommender):
    name = "ials"
    _loss_lags_one_epoch = True
    _stats_order = "post"

    def _reg_vectors(self, dd: DeviceData):
        return ials_reg_vectors(self.cfg, dd)

    def _sweep(self, table_self, table_other, buckets, num_choices,
               gram=None, pre_list=None, q_prev=None, eig=None, t_rot=None):
        """Returns (new table, new eigenbasis or None). ``eig`` is the
        Gramian's (Q, lam); None computes it, warm from ``q_prev``.
        ``t_rot`` is ``table_other`` rotated into it, or None
        (``common.solve_sweep`` rotates it)."""
        cfg = self.cfg
        if gram is None:
            gram = table_other.T @ table_other
        if eig is None:
            eig = woodbury.maybe_eigh(gram, cfg.dim, use_cg=cfg.use_cg,
                                      q_prev=q_prev,
                                      refresh_tol=cfg.eig_refresh_tol)
        table_other = assemble.cast(table_other, self.asm_dtype)

        def params_fn(b, pre, other):
            reg = common.ials_reg(b.length, num_choices, cfg.l2_reg,
                                  cfg.l2_reg_exp, cfg.uobs_weight)
            return common.params_ials(other, b, reg, cfg.uobs_weight,
                                      dtype=self.asm_dtype, pre=pre)

        out = common.solve_sweep(table_self, buckets, params_fn, gram,
                                 table_other=table_other, eig=eig,
                                 t_rot=t_rot, use_cg=cfg.use_cg,
                                 cg_tol=cfg.cg_error_tolerance,
                                 cg_iters=cfg.cg_max_iterations,
                                 pre_list=pre_list)
        return out, (eig[0] if eig is not None else None)

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        # The reference's end-of-epoch ComputeUserLoss (ials.h:205-206;
        # stats-only) runs at the top of the next epoch, where it shares
        # the user sweep's gather; state.item_gramian carries V^T V
        # across the boundary. The stored user_loss therefore describes
        # the carried (pre-epoch) model.
        loss, pre = common.gather_and_losses(
            state.item_emb, dd.by_user, state.user_emb,
            state.item_gramian, dd.num_users, self.cfg.uobs_weight,
            halve=False, dtype=self.asm_dtype)
        u, qn_u = self._sweep(state.user_emb, state.item_emb, dd.by_user,
                              dd.num_items, gram=state.item_gramian,
                              pre_list=pre, q_prev=state.eig_qu)
        del pre
        v, qn_v = self._sweep(state.item_emb, u, dd.by_item,
                              dd.num_users, q_prev=state.eig_qv)
        return state.replace(user_emb=u, item_emb=v, item_gramian=v.T @ v,
                             user_loss=loss, steps=state.steps + 1,
                             eig_qu=qn_u if qn_u is not None
                             else state.eig_qu,
                             eig_qv=qn_v if qn_v is not None
                             else state.eig_qv)

    def _fold_in_prep(self, state: MFState):
        cfg = self.cfg
        eig = woodbury.maybe_eigh(state.item_gramian, cfg.dim,
                                  use_cg=cfg.use_cg, q_prev=state.eig_qu,
                                  refresh_tol=cfg.eig_refresh_tol)
        return eig, common.rotated_items(eig, state.item_emb, self.asm_dtype)

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """One exact re-projection of the held-out users
        (reference ials.h:169-174)."""
        ue = torch.zeros((fold.n_pad, self.cfg.dim), device=self.device)
        eig, t_rot = self._fold_in_prep(state) if prep is None else prep
        return self._sweep(ue, state.item_emb, fold.by_user,
                           self.num_items, gram=state.item_gramian,
                           eig=eig, t_rot=t_rot)[0]
