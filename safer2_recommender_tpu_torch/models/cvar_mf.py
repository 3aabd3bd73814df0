"""CVaR-MF: the non-smooth CVaR baseline, projected subgradient descent
(the counterpart of ``safer2_recommender_tpu/models/cvar_mf.py``).

  z-step : hard indicator z_u = [loss_u - xi >= 0]   (cvar_mf.h:597-642)
  U-step : gradient step u <- u - eta (A u - rhs)    (cvar_mf.h:88-134)
  V-step : gradient step on items, using the *pre-U-step* user embeddings
           (cvar_mf.h:282-295)
  xi     : exact alpha-quantile of the loss vector   (cvar_mf.h:582-595)
  eval   : closed-form fold-in with weight 1         (cvar_mf.h:182-229)
"""

from __future__ import annotations

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData, FoldInData
from safer2_recommender_tpu_torch.models import common
from safer2_recommender_tpu_torch.models.base import (MFState, Recommender,
                                                      SaferFamilyMixin, _log)
from safer2_recommender_tpu_torch.ops import (assemble, grad_gather, quantile,
                                              woodbury)
from safer2_recommender_tpu_torch.utils.device import f32_matmul
from safer2_recommender_tpu_torch.utils.logging import span


def _grad_span(b, dim: int):
    """The ``sweep.grad`` span of one bucket's gather-and-step: its
    padded ``rows``, ``width``, and whether it streams (``wide``)."""
    return span("sweep.grad", rows=b.n_rows, width=b.width,
                wide=assemble.is_wide(b, dim))


def _fresh(table):
    """The copy a sweep steps in place (contiguous, as the kernel writes
    it)."""
    return table.clone(memory_format=torch.contiguous_format)


class CVaRMF(SaferFamilyMixin, Recommender):
    name = "cvar_mf"
    _loss_lags_one_epoch = True

    def _log_epoch_lines(self) -> None:
        # reference cvar_mf.h:301-303, :327-328
        self._log_weighted_loss()
        _log.info("Mean weights: %s", self.get_mean_weight())
        _log.info("Xi:%s", float(self.state.xi))

    def _grad_step_u(self, ue, item_emb, gramian, buckets, dual,
                     pre_list=None, kernel=False):
        """Returns a NEW user table one gradient step from ``ue`` (the
        ranks' rows shared on the buckets' mesh). With ``kernel`` (see
        ``_epoch``) a bucket is one ``grad_gather.user_step``, which
        gathers no slab, and ``pre_list`` is unread."""
        cfg = self.cfg
        reg = self._user_reg()
        item_emb = assemble.cast(item_emb, self.asm_dtype)   # once a sweep
        if kernel:
            item_emb = item_emb.contiguous()

        def body(ue, b, pre):
            with _grad_span(b, cfg.dim):
                if kernel:
                    return grad_gather.user_step(
                        ue, item_emb, b, gramian, cfg.stepsize, reg=reg,
                        uobs=cfg.uobs_weight, dual=dual)
                w = dual[b.row_ids.clamp(max=dual.shape[0] - 1)]
                p = common.params_weighted_mean(
                    item_emb, b,
                    torch.full((b.n_rows,), reg, device=ue.device),
                    cfg.uobs_weight, w, dtype=self.asm_dtype, pre=pre)
                u_rows = assemble.read_rows(ue, b)
                grad = common.grad_from_params(p, gramian, u_rows)
                return assemble.scatter_bucket(ue, b,
                                               u_rows - cfg.stepsize * grad)

        return common.share_rows(
            common.sweep_apply(buckets, pre_list, _fresh(ue), body),
            buckets)

    def _grad_step_v(self, v, user_emb, dd: DeviceData, dual,
                     kernel=False):
        """Returns a NEW item table one gradient step from ``v``; with
        ``kernel`` as ``_grad_step_u`` (``grad_gather.item_step``), with
        every item's ridge made once a sweep."""
        cfg = self.cfg
        w_gram = user_emb.T @ (user_emb * dual[:, None])
        norm_dual = self._norm_dual(dd, dual)
        user_c = assemble.cast(user_emb, self.asm_dtype)     # once a sweep
        if kernel:
            user_c = user_c.contiguous()
            reg_all = self._item_reg(dd.item_reg, torch.arange(
                dd.item_reg.shape[0], device=v.device))

        def body(v, b, _):
            with _grad_span(b, cfg.dim):
                if kernel:
                    return grad_gather.item_step(
                        v, user_c, b, w_gram, cfg.stepsize, reg=reg_all,
                        uobs=cfg.uobs_weight, norm_dual=norm_dual)
                reg = self._item_reg(dd.item_reg, b.row_ids)
                p = common.params_weighted_item(user_c, b, reg,
                                                cfg.uobs_weight, norm_dual,
                                                dtype=self.asm_dtype)
                v_rows = assemble.read_rows(v, b)
                grad = common.grad_from_params(p, w_gram, v_rows)
                return assemble.scatter_bucket(v, b,
                                               v_rows - cfg.stepsize * grad)

        return common.share_rows(
            common.sweep_apply(dd.by_item, None, _fresh(v), body),
            dd.by_item)

    def _epoch(self, state: MFState, dd: DeviceData) -> MFState:
        """Phase-shifted like ``SAFER2._epoch``: the reference's trailing
        {loss, xi = exact quantile} (cvar_mf.h:300-306) runs at the top
        of the next epoch, where the loss pass shares the U-step's
        gather. Epoch 0 keeps the carried xi (the reference's prev_xi_
        is 0-initialized and Initialize computes only the loss,
        cvar_mf.h:710-726), so the update sequence is identical. Each
        phase is a device-timed span (``utils/logging.py::EPOCH_PHASES``),
        and each bucket of the two gradient steps a ``sweep.grad``. The
        route is chosen here, once: a float32 assembly of CUDA tables
        takes the gather-matvec kernel in both steps
        (``grad_gather.applies``), and then the U-step reads no slab, so
        the loss pass keeps none."""
        cfg, dev = self.cfg, self.device
        kernel = self.asm_dtype is None and grad_gather.applies(
            state.item_emb)
        with span("epoch.loss", dev):
            loss, pre = common.gather_and_losses(
                state.item_emb, dd.by_user, state.user_emb,
                state.item_gramian, dd.num_users, cfg.uobs_weight,
                halve=True, dtype=self.asm_dtype,
                budget_bytes=0 if kernel else common.FUSE_BUDGET_BYTES)
        with span("epoch.xi", dev):
            xi = state.xi if state.steps == 0 else quantile.exact_quantile(
                loss, cfg.alpha)
        with span("epoch.z", dev):
            dual = torch.where(dd.user_hist_size > 0,
                               (loss - xi >= 0.0).to(torch.float32),
                               state.dual_weight)
        with span("epoch.u_sweep", dev):
            u = self._grad_step_u(state.user_emb, state.item_emb,
                                  state.item_gramian, dd.by_user, dual,
                                  pre_list=pre, kernel=kernel)
        del pre
        # StepV uses the pre-update user embeddings (cvar_mf.h:282-295)
        with span("epoch.v_sweep", dev):
            v = self._grad_step_v(state.item_emb, state.user_emb, dd, dual,
                                  kernel=kernel)
        with span("epoch.gram", dev):
            gram = v.T @ v
        return state.replace(user_emb=u, item_emb=v, item_gramian=gram,
                             user_loss=loss, dual_weight=dual, xi=xi,
                             steps=state.steps + 1)

    @f32_matmul()
    def initialize(self, dd: DeviceData) -> None:
        """Pre-compute losses (reference cvar_mf.h:710-726)."""
        self._init_losses(dd)

    def _fold_in_prep(self, state: MFState):
        """``(eig, t_rot)``: (Q, lam) of the item Gramian by a full eigh
        (no warm basis: training never solves exactly), or None on the
        direct path, and the item table rotated into it."""
        eig = woodbury.maybe_eigh(state.item_gramian, self.cfg.dim,
                                  use_cg=False)
        return eig, common.rotated_items(eig, state.item_emb, self.asm_dtype)

    def _fold_in_split(self):
        """As the base class's, but ``use_cg`` does not apply: this
        fold-in always solves directly."""
        if self.cfg.dim < woodbury.MIN_DIM:
            return None
        return self.cfg.dim // 2

    def _fold_in(self, state: MFState, fold: FoldInData,
                 prep=None) -> torch.Tensor:
        """Closed-form fold-in with weight 1 (reference cvar_mf.h:644-692:
        StepU_eval -> ProjectU_eval Cholesky solve)."""
        cfg = self.cfg
        ue = torch.zeros((fold.n_pad, cfg.dim), device=self.device)
        reg = self._user_reg()
        eig, t_rot = self._fold_in_prep(state) if prep is None else prep
        item_emb = assemble.cast(state.item_emb, self.asm_dtype)

        def params_fn(b, pre, other):
            return common.params_weighted_mean(
                other, b,
                torch.full((b.n_rows,), reg, device=self.device),
                cfg.uobs_weight, torch.ones((b.n_rows,), device=self.device),
                dtype=self.asm_dtype)

        return common.solve_sweep(ue, fold.by_user, params_fn,
                                  state.item_gramian, table_other=item_emb,
                                  eig=eig, t_rot=t_rot)
