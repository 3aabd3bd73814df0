"""SAFER2's epoch, plain PyTorch (safer2.h:104-334).

One epoch from (U, V, G = V^T V, loss, z, xi):
  loss   per-user halved loss of (U, V)            (safer2.h:85-101)
  xi     Newton-Raphson from the mean loss on the first epoch, the
         carried xi after                           (safer2.h:819-838)
  z      1 - K_cdf(-(loss - xi); h) for users with a history
  U      per user: (z/|H| sum_h v v^T + z uobs G + l2 (1 + uobs n_items) I)
         u = z/|H| sum_h v                          (safer2.h:104-163)
  V      per item: (sum_h z_u/|H_u| u u^T + uobs U^T diag(z) U
         + l2 (sum_h 1/|H_u| + alpha uobs n_users) I) v
         = sum_h z_u/|H_u| u                        (safer2.h:166-221)
  G      V^T V
The stored loss is the pre-epoch model's, as in the program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference.common import (Prec, Side, block_rows,
                                        compute_xi, dual_weight, exact_rows,
                                        row_systems, user_losses)


class Problem:
    """The training data and configuration as the reference sees them:
    both sides' histories, the SAFER family's statistics, and ``order``
    (position -> user id), the program's numbering of its users, which
    the sub-sampled Newton steps index."""

    def __init__(self, users: np.ndarray, items: np.ndarray, num_users: int,
                 num_items: int, cfg: dict, device, order: np.ndarray):
        self.cfg = cfg
        self.num_users, self.num_items = num_users, num_items
        self.device = device
        self.by_user = Side(users, items, num_users, device)
        self.by_item = Side(items, users, num_items, device)
        hist = self.by_user.lengths.astype(np.float64)
        self.hist = torch.from_numpy(hist).to(device)
        self.present = self.hist > 0
        inv = np.where(hist > 0, 1.0 / np.maximum(hist, 1.0), 0.0)
        self.item_stat = torch.from_numpy(np.bincount(
            items, weights=inv[users], minlength=num_items)).to(device)
        self.order = torch.from_numpy(
            np.asarray(order, dtype=np.int64)).to(device)


def start_state(prob: Problem, u0: torch.Tensor, v0: torch.Tensor,
                prec: Prec) -> dict:
    """The state before the first epoch, from the benchmark's tables: the
    initial losses, z = alpha, xi = 0."""
    cfg = prob.cfg
    u, v = u0.to(prec.dtype), v0.to(prec.dtype)
    with prec.matmul():
        g = v.T @ v
    loss = user_losses(prob.by_user, u, v, g, cfg["uobs_weight"], prec)
    return dict(user_emb=u, item_emb=v, gram=g, user_loss=loss,
                dual_weight=torch.full_like(loss, cfg["alpha"]),
                xi=torch.zeros((), dtype=prec.dtype, device=u.device),
                steps=0)


def user_reg(prob: Problem) -> float:
    cfg = prob.cfg
    return cfg["l2_reg"] * (1.0 + cfg["uobs_weight"] * prob.num_items)


def item_reg(prob: Problem) -> torch.Tensor:
    cfg = prob.cfg
    return cfg["l2_reg"] * (prob.item_stat + cfg["alpha"]
                            * cfg["uobs_weight"] * prob.num_users)


def z_step(prob: Problem, state: dict, gen, prec: Prec, every_id: bool):
    """(loss, xi, z) at the top of an epoch."""
    cfg = prob.cfg
    loss = user_losses(prob.by_user, state["user_emb"], state["item_emb"],
                       state["gram"], cfg["uobs_weight"], prec)
    warm = loss.mean() if state["steps"] == 0 else state["xi"]
    xi = compute_xi(loss, warm, cfg, gen, prob.order)
    z = dual_weight(loss, xi, cfg["bandwidth"])
    if not every_id:
        z = torch.where(prob.present, z, state["dual_weight"])
    return loss, xi, z


def sweep(side: Side, table: torch.Tensor, other: torch.Tensor,
          g: torch.Tensor, slot_weight: torch.Tensor, cg: torch.Tensor,
          reg: torch.Tensor, prec: Prec, *, block: int = 0,
          exact_max: Optional[int] = None, skip=None) -> torch.Tensor:
    """Every row with a history against the frozen ``other``: its exact
    solve, or (``block``, rows longer than ``exact_max``) one block pass
    from its current value. ``cg``, ``reg`` are per row of the side;
    ``skip`` marks rows left as they are (a planted fault)."""
    out = table.clone()
    for rows in side.groups():
        if skip is not None:
            rows = rows[~skip[rows]]
            if rows.size == 0:
                continue
        r = torch.from_numpy(rows).to(table.device)
        s, b = row_systems(side, other, rows, slot_weight, prec)
        long = (side.lengths[rows] > exact_max) if block else (
            np.zeros(rows.size, bool))
        if long.all():
            x = block_rows(table[r], s, b, g, cg[r], reg[r], block, prec)
        elif not long.any():
            x = exact_rows(s, b, g, cg[r], reg[r], prec)
        else:
            x = torch.empty((rows.size, table.shape[1]), dtype=table.dtype,
                            device=table.device)
            for sel, solve in ((long, "block"), (~long, "exact")):
                k = torch.from_numpy(np.flatnonzero(sel)).to(table.device)
                rk = r[k]
                if solve == "exact":
                    x[k] = exact_rows(s[k], b[k], g, cg[rk], reg[rk], prec)
                else:
                    x[k] = block_rows(table[rk], s[k], b[k], g, cg[rk],
                                      reg[rk], block, prec)
        out[r] = x
        del s, b
    return out


def _sides(prob: Problem, state: dict, z: torch.Tensor, prec: Prec,
           fault=None, block: int = 0, exact_max: Optional[int] = None):
    cfg = prob.cfg
    u, v, g = state["user_emb"], state["item_emb"], state["gram"]
    skip = None
    if fault == "half_batch":
        # half of the users left out of the U sweep, and of the item
        # side's Gramian and slot weights
        skip = np.arange(prob.num_users) % 2 == 1
    # user side: slot weight z_u / |H_u| by slot, cg = z uobs, scalar reg
    w_u = torch.where(prob.present, z / prob.hist.clamp(min=1.0), 0.0)
    slot_u = w_u[prob.by_user.rows_of_slot]
    cg_u = cfg["uobs_weight"] * z
    reg_u = torch.full_like(z, user_reg(prob))
    u1 = sweep(prob.by_user, u, v, g, slot_u, cg_u, reg_u, prec,
               block=block, exact_max=exact_max, skip=skip)
    zk = z
    if skip is not None:
        zk = torch.where(torch.from_numpy(~skip).to(z.device), z, 0.0)
        w_u = torch.where(torch.from_numpy(~skip).to(z.device), w_u, 0.0)
    with prec.matmul():
        g_w = u1.T @ (u1 * zk[:, None])
    # item side: slot weight z_u / |H_u| of the slot's user, cg = uobs
    slot_v = w_u[prob.by_item.cols]
    cg_v = torch.full((prob.num_items,), cfg["uobs_weight"],
                      dtype=prec.dtype, device=u.device)
    v1 = sweep(prob.by_item, v, u1, g_w, slot_v, cg_v,
               item_reg(prob).to(prec.dtype), prec, block=block,
               exact_max=exact_max)
    with prec.matmul():
        g1 = v1.T @ v1
    return u1, v1, g1


def epoch(prob: Problem, state: dict, gen, prec: Prec,
          fault: Optional[str] = None) -> dict:
    loss, xi, z = z_step(prob, state, gen, prec, every_id=False)
    u1, v1, g1 = _sides(prob, state, z, prec, fault)
    return dict(user_emb=u1, item_emb=v1, gram=g1, user_loss=loss,
                dual_weight=z, xi=xi, steps=state["steps"] + 1)
