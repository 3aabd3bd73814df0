"""Carry a JAX-package model state into the port.

The JAX package initializes its tables with ``jax.random``, which torch
cannot reproduce, so the two packages start from the same tables only
when one hands them to the other. ``safer2_recommender_tpu``'s
``Recommender.export_state()`` gives a numpy dict in ORIGINAL id space;
``state_from_jax`` maps it into the port's solver order. Only numpy
crosses the boundary: this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from safer2_recommender_tpu_torch.data.dataset import DeviceData
from safer2_recommender_tpu_torch.models.base import Recommender


def state_from_jax(exported: dict, model: Recommender, dd: DeviceData,
                   steps: int = 0, eig=None) -> None:
    """Set ``model.state`` from ``exported`` (keys user_emb, item_emb,
    user_loss, dual_weight, xi, original id space), reordered through
    ``dd``'s solver order; ``item_gramian`` is recomputed and ``steps``
    set (0 for a freshly initialized JAX model).

    ``eig=(qu, qv)``, numpy [dim, dim] each, carries the JAX model's warm
    Woodbury eigenbases (its ``state.eig_qu`` / ``state.eig_qv``), so a
    trained state's next epoch refreshes from the same bases. Without it
    the bases are the identity, as in a fresh JAX model. They live in
    the embedding space, so no reordering applies."""
    uo = dd.user_order.cpu().numpy()
    io = dd.item_order.cpu().numpy()
    dev = model.device

    def rows(name, order):
        x = np.asarray(exported[name], dtype=np.float32)
        if x.shape[0] != order.size:
            raise ValueError(f"{name} has {x.shape[0]} rows, the data has "
                             f"{order.size}")
        # solver slot j holds original id order[j]
        return torch.from_numpy(np.ascontiguousarray(x[order])).to(dev)

    dim = model.cfg.dim
    if eig is None:
        qu = qv = torch.eye(dim, device=dev)
    else:
        qu, qv = (torch.from_numpy(np.array(q, dtype=np.float32)).to(dev)
                  for q in eig)
        if qu.shape != (dim, dim) or qv.shape != (dim, dim):
            raise ValueError(f"eig bases must be [{dim}, {dim}], got "
                             f"{tuple(qu.shape)} and {tuple(qv.shape)}")

    model._note_perms(dd)
    item_emb = rows("item_emb", io)
    model.state = model.state.replace(
        user_emb=rows("user_emb", uo),
        item_emb=item_emb,
        item_gramian=item_emb.T @ item_emb,
        user_loss=rows("user_loss", uo),
        dual_weight=rows("dual_weight", uo),
        xi=torch.tensor(float(exported["xi"]), dtype=torch.float32,
                        device=dev),
        steps=steps,
        eig_qu=qu,
        eig_qv=qv,
    )
