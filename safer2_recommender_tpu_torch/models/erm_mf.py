"""ERM-MF: the risk-neutral baseline of SAFER2 (the counterpart of
``safer2_recommender_tpu/models/erm_mf.py``).

Per-user *mean* squared loss, constant dual weight alpha, exact
alternating solves with a dual-weighted item-side Gramian
(erm_mf.h:462-467), and the SAFER-family regularizers:

  user: reg * (1 + uobs * num_items)                (erm_mf.h:384-387)
  item: reg * (item_reg_v + alpha * uobs * num_users)  (erm_mf.h:389-395)
    with item_reg_v = sum_{u in H_v} 1 / |H_u|      (erm_mf.h:580-586)

Epoch = StepU (weight alpha, cached Gramian), StepV, refresh V^T V,
per-user losses (erm_mf.h:257-301).
"""

from __future__ import annotations

from safer2_recommender_tpu_torch.data.dataset import DeviceData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import (MFState, Recommender,
                                                      SaferFamilyMixin)
from safer2_recommender_tpu_torch.utils.device import f32_matmul


class ERMMF(SaferFamilyMixin, Recommender):
    name = "erm_mf"
    _loss_lags_one_epoch = True

    def _log_epoch_lines(self) -> None:
        # reference erm_mf.h:277-278
        self._log_weighted_loss()

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        # The end-of-epoch ComputeUserLoss (erm_mf.h:275-276; stats-only:
        # ERM's dual weight is the constant alpha) runs at the top of the
        # next epoch, where it shares the U-sweep's gather; the stored
        # user_loss therefore describes the carried (pre-epoch) model.
        loss, pre = common.gather_and_losses(
            state.item_emb, dd.by_user, state.user_emb,
            state.item_gramian, dd.num_users, self.cfg.uobs_weight,
            halve=True, dtype=self.asm_dtype)
        u, qn_u = self._step_u(state.user_emb, state.item_emb,
                               state.item_gramian, dd.by_user,
                               state.dual_weight, pre_list=pre,
                               q_prev=state.eig_qu)
        del pre
        v, qn_v = self._step_v(state.item_emb, u, dd, state.dual_weight,
                               q_prev=state.eig_qv)
        return state.replace(user_emb=u, item_emb=v, item_gramian=v.T @ v,
                             user_loss=loss, steps=state.steps + 1,
                             eig_qu=qn_u if qn_u is not None
                             else state.eig_qu,
                             eig_qv=qn_v if qn_v is not None
                             else state.eig_qv)

    @f32_matmul()
    def initialize(self, dd: DeviceData) -> None:
        """Pre-compute losses (reference erm_mf.h:573-587; history sizes
        and item_reg live in DeviceData)."""
        self._init_losses(dd)
