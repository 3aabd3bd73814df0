"""Training statistics: the reference's loss-decomposition log line (the
counterpart of ``safer2_recommender_tpu/models/stats.py``; the CLI
prints it by default, ``--print_train_stats 1``):

  Loss=..  Loss_observed=(pred-1)^2 sum / num_tuples
  Loss_unobserved=sum(G_U * G_V) / n_items / n_users
  Loss_reg=sum_u ||u||^2 reg_u + sum_v ||v||^2 reg_v
  Loss_reg (user)=mean ||u||^2, Loss_reg (item)=mean ||v||^2

plus the NaN abort (the reference logs and exits, ials.h:291-296; this
raises so callers can handle it).
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData
from safer2_recommender_tpu_torch.ops import assemble
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)


def loss_decomposition(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    user_loss: torch.Tensor,
    dd: DeviceData,
    user_reg_vec: torch.Tensor,   # [num_users] per-row reg value
    item_reg_vec: torch.Tensor,   # [num_items]
    uobs: float,
    *,
    loss_is_user_sum: bool,
) -> Tuple[torch.Tensor, ...]:
    """Returns (loss, loss_observed, loss_unobserved, loss_reg,
    reg_user_now, reg_item_now), the six scalars of the stats line."""
    loss_observed = torch.zeros((), device=user_emb.device)
    for b in dd.by_user:
        u = assemble.read_rows(user_emb, b)
        emb, mask = assemble.gather_history(item_emb, b)
        p = assemble.rowwise_dot(emb, u)
        loss_observed = loss_observed + (torch.square(p - 1.0) * mask).sum()

    u_present = (dd.user_hist_size > 0).to(torch.float32)
    i_present = (dd.item_hist_size > 0).to(torch.float32)
    u_norms = torch.square(user_emb).sum(dim=1)
    i_norms = torch.square(item_emb).sum(dim=1)
    loss_reg = (u_norms * user_reg_vec * u_present).sum() + (
        i_norms * item_reg_vec * i_present).sum()
    reg_user_now = (u_norms * u_present).sum()
    reg_item_now = (i_norms * i_present).sum()
    loss_unobserved = ((user_emb.T @ user_emb)
                       * (item_emb.T @ item_emb)).sum()
    if loss_is_user_sum:
        # SAFER family logs the sum of per-user losses (safer2.h:388)
        loss = user_loss.sum()
    else:
        loss = loss_observed + uobs * loss_unobserved + loss_reg
    return (loss, loss_observed, loss_unobserved, loss_reg,
            reg_user_now, reg_item_now)


def log_loss_decomposition(values, dd: DeviceData, duration_ms: int) -> None:
    loss, obs, unobs, reg, reg_u, reg_i = (float(v) for v in values)
    if loss != loss:  # NaN
        _log.error("!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!")
        _log.error("NaN is detected!!")
        _log.error("!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!!")
        raise FloatingPointError(
            "NaN detected in training loss (the reference aborts here, "
            "ials.h:291-296)")
    _log.info(
        "Loss=%.2f Loss_observed=%.2f Loss_unobserved=%.2f Loss_reg=%.2f "
        "Loss_reg (user)=%.2f Loss_reg (item)=%.2f",
        loss, obs / dd.nnz, unobs / dd.num_items / dd.num_users, reg,
        reg_u / dd.num_users, reg_i / dd.num_items)
    _log.info("Time=%d", duration_ms)
