"""CVaR-MF's epoch, plain PyTorch (the reference C++'s ``cvar_mf.h``).

One epoch from (U, V, G = V^T V, loss, z, xi):
  loss   per-user halved loss of (U, V)             (cvar_mf.h:300-306)
  xi     carried on the first epoch (prev_xi_ starts at 0); after it
         the exact alpha-quantile, the floor(n alpha)-th largest loss
         by a full sort                              (cvar_mf.h:582-595)
  z      [loss_u - xi >= 0] for users with a history (cvar_mf.h:597-642)
  U      per user one gradient step u <- u - eta (A u - rhs), with
         A u = z/|H| sum_h v (v . u) + z uobs G u + l2 (1 + uobs n_items) u
         and rhs = z/|H| sum_h v                     (cvar_mf.h:88-134)
  V      per item one gradient step against U^T diag(z) U, from the
         pre-update U: A v = sum_h z_u/|H_u| u (u . v) + uobs U^T diag(z) U v
         + l2 (sum_h 1/|H_u| + alpha uobs n_users) v,
         rhs = sum_h z_u/|H_u| u         (cvar_mf.h:136-180, :282-295)
  G      V^T V
The stored loss is the pre-epoch model's, as in the program.

Departures from ``cvar_mf.h``, each also the program's:
  * the trailing {loss, xi} of an epoch runs at the top of the next
    one, which reads the same tables, so the update sequence is the
    same; the first epoch keeps the carried xi (0);
  * the quantile index is clamped to n - 1 (alpha = 1 reads past the
    end in the C++);
  * ``A u - rhs`` is formed by matrix-vector products over the gathered
    history, in slabs of rows, never as the d x d matrix A (the C++
    forms the same products per row);
  * ``settle``, when given, may replace z after the z-step: the
    benchmark's near-tie rule (``portbench/drivers/train_hard.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from portbench.reference import safer2
from portbench.reference.common import Prec, Side, user_losses

Problem = safer2.Problem
start_state = safer2.start_state


def exact_quantile(loss: torch.Tensor, alpha: float) -> torch.Tensor:
    """The floor(n alpha)-th largest loss (0 the largest), the index
    clamped to n - 1."""
    n = loss.shape[0]
    q = min(int(n * alpha), n - 1)
    return torch.sort(loss, descending=True).values[q]


def grad_sweep(side: Side, table: torch.Tensor, other: torch.Tensor,
               g: torch.Tensor, slot_weight: torch.Tensor,
               cg: torch.Tensor, reg: torch.Tensor, eta: float, prec: Prec,
               skip=None) -> torch.Tensor:
    """Every row with a history one step x <- x - eta (A x - rhs) against
    the frozen ``other``: A x - rhs = reg x + cg (x G) + sum_h w_h
    (o_h . x - 1) o_h (``o`` the rows of ``other`` in the row's history,
    ``w`` the per-slot weights, by slot). ``cg``, ``reg`` are per row of
    the side; ``skip`` marks rows left as they are (a planted fault)."""
    out = table.clone()
    for rows in side.groups():
        if skip is not None:
            rows = rows[~skip[rows]]
            if rows.size == 0:
                continue
        r = torch.from_numpy(rows).to(table.device)
        x = table[r]
        acc = torch.zeros_like(x)
        with prec.matmul():
            for slot, mask in side.slabs(rows):
                emb = other[side.cols[slot]]
                w = torch.where(mask, slot_weight[slot], 0.0).to(prec.dtype)
                pred = torch.bmm(emb, x[:, :, None])[:, :, 0]
                acc += torch.bmm(((pred - 1.0) * w)[:, None, :], emb)[:, 0]
                del emb
            grad = reg[r][:, None] * x + cg[r][:, None] * (x @ g) + acc
        out[r] = x - eta * grad
    return out


def epoch(prob: Problem, state: dict, gen, prec: Prec,
          fault: Optional[str] = None,
          settle: Optional[Callable] = None) -> dict:
    """One epoch; ``gen`` is unused (CVaR-MF draws nothing). ``settle
    (loss, xi, z) -> z`` may replace the z-step's indicator."""
    cfg = prob.cfg
    u, v, g = state["user_emb"], state["item_emb"], state["gram"]
    loss = user_losses(prob.by_user, u, v, g, cfg["uobs_weight"], prec)
    xi = state["xi"] if state["steps"] == 0 else exact_quantile(
        loss, cfg["alpha"])
    z = torch.where(prob.present, (loss - xi >= 0).to(prec.dtype),
                    state["dual_weight"])
    if settle is not None:
        z = settle(loss, xi, z)
    skip = None
    if fault == "half_batch":
        # half of the users left out of the U step, and of the item
        # side's Gramian and slot weights
        skip = np.arange(prob.num_users) % 2 == 1
    uobs, eta = cfg["uobs_weight"], cfg["stepsize"]
    w_u = torch.where(prob.present, z / prob.hist.clamp(min=1.0), 0.0)
    u1 = grad_sweep(prob.by_user, u, v, g, w_u[prob.by_user.rows_of_slot],
                    uobs * z, torch.full_like(z, safer2.user_reg(prob)),
                    eta, prec, skip=skip)
    zk = z
    if skip is not None:
        keep = torch.from_numpy(~skip).to(z.device)
        zk = torch.where(keep, z, 0.0)
        w_u = torch.where(keep, w_u, 0.0)
    with prec.matmul():
        g_w = u.T @ (u * zk[:, None])
    cg_v = torch.full((prob.num_items,), uobs, dtype=prec.dtype,
                      device=u.device)
    v1 = grad_sweep(prob.by_item, v, u, g_w, w_u[prob.by_item.cols], cg_v,
                    safer2.item_reg(prob).to(prec.dtype), eta, prec)
    with prec.matmul():
        g1 = v1.T @ v1
    return dict(user_emb=u1, item_emb=v1, gram=g1, user_loss=loss,
                dual_weight=z, xi=xi, steps=state["steps"] + 1)
