"""SAFER2: smoothed-CVaR primal-dual block-coordinate training (the
counterpart of ``safer2_recommender_tpu/models/safer2.py``).

  z-step : z_u = 1 - K_cdf(-(loss_u - xi); h)     (safer2.h:745-794)
  U-step : weighted mean-normalized exact solves  (safer2.h:104-163)
  V-step : dual-weighted Gramian exact solves     (safer2.h:166-221)
  xi-step: smoothed-quantile Newton-Raphson with Armijo line search and
           optional sub-sampled NR                (safer2.h:652-742)

``get_mean_weight`` tracks alpha (Proposition C.1, safer2.h:812-817).
"""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import (MFState, Recommender,
                                                      SaferFamilyMixin, _log)
from safer2_recommender_tpu_torch.ops import quantile, smoothing


class SAFER2(SaferFamilyMixin, Recommender):
    name = "safer2"
    _loss_lags_one_epoch = True

    def _log_epoch_lines(self) -> None:
        # reference safer2.h:300-301, :332
        self._log_weighted_loss()
        _log.info("Xi:%s", float(self.state.xi))

    def _xi(self, loss: torch.Tensor, state: MFState,
            xi: torch.Tensor) -> torch.Tensor:
        """NR from the warm start: mean loss on the first epoch (the
        reference's Initialize), the carried xi after."""
        cfg = self.cfg
        warm = loss.mean() if state.steps == 0 else xi
        return quantile.compute_xi(
            loss, warm, self.generator, nr_iterations=cfg.xi_iterations,
            bandwidth=cfg.bandwidth, alpha=cfg.alpha,
            use_epanechnikov=cfg.use_epanechnikov, use_snr=cfg.use_snr,
            sampling_ratio=cfg.sampling_ratio)

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        """One Train call, phase-shifted so the loss pass shares the
        U-sweep's gather.

        The reference epoch is ``pd x {z, U, V, gram, loss} ; xi``
        (safer2.h:266-334) with Initialize pre-computing loss and xi.
        Nothing changes (u, v) between one epoch's trailing {loss, xi}
        and the next epoch's leading z, so the same update sequence runs
        as ``pd x {loss, [xi at t=0], z, U, V, gram}`` with the xi warm
        start selected by ``state.steps``.
        """
        cfg = self.cfg
        present = dd.user_hist_size > 0
        u, v = state.user_emb, state.item_emb
        gram = state.item_gramian
        dual, xi = state.dual_weight, state.xi
        eq_u, eq_v = state.eig_qu, state.eig_qv
        loss = state.user_loss
        if cfg.pd_iterations == 0:
            # the reference still runs the trailing ComputeXi on the
            # carried loss when the pd loop is empty (safer2.h:331-334)
            xi = self._xi(loss, state, xi)
        for t in range(cfg.pd_iterations):
            loss, pre = common.gather_and_losses(
                v, dd.by_user, u, gram, dd.num_users, cfg.uobs_weight,
                halve=True)
            if t == 0:
                xi = self._xi(loss, state, xi)
            dual = torch.where(
                present,
                smoothing.dual_weight(loss, xi, cfg.bandwidth,
                                      cfg.use_epanechnikov),
                dual)
            u, qn = self._step_u(u, v, gram, dd.by_user, dual,
                                 pre_list=pre, q_prev=eq_u)
            eq_u = qn if qn is not None else eq_u
            del pre     # the loss pass's kept slabs: the V sweep frees them
            v, qn = self._step_v(v, u, dd, dual, q_prev=eq_v)
            eq_v = qn if qn is not None else eq_v
            gram = v.T @ v
        return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                             user_loss=loss, dual_weight=dual, xi=xi,
                             steps=state.steps + 1, eig_qu=eq_u,
                             eig_qv=eq_v)

    def initialize(self, dd: DeviceData) -> None:
        """Reference safer2.h:819-838. The loss/xi warm start runs at the
        top of the first epoch (see ``_epoch``); here only the loss is
        computed, so the pre-training state is inspectable."""
        self._note_perms(dd)
        s = self.state
        loss = common.user_losses(s.user_emb, s.item_emb, s.item_gramian,
                                  dd.by_user, dd.num_users,
                                  self.cfg.uobs_weight, halve=True)
        self.state = s.replace(user_loss=loss, steps=0)
