"""Training traffic for a model whose z-step is a hard indicator
(CVaR-MF: z_u = [loss_u - xi >= 0]), with the near-tie rule.

The program runs as in ``drivers/train.py``: the same set-up, tables,
checked epochs and snapshots, then ``Recommender.train_epochs(dd, 1)``
in a loop for ``--seconds``; ``train_users_per_s`` is the training
users times the epochs over the window.

The float64 reference then follows the checked epochs from the same
tables. A sound float32 program and a float64 follower disagree on z
for users whose loss lies within rounding of xi: near the quantile the
losses are packed far closer than float32 resolves, and each flip moves
that user's row by a whole gradient step. So at each checked epoch's
z-step the follower computes its own float64 losses, xi and z, and
where a user's loss lies in the band

    |loss_u - xi| <= tau * max(|loss_u|, |xi|)

it takes that user's z from the program's snapshot of the same epoch;
outside the band it keeps its own. ``tau`` is fixed in the cell's
limits file (its ``tau`` entry), never derived from the program. The
checks are the five leaf gaps of ``drivers/train.py`` against the
follower, and ``z_outside_band``: the users whose z differs from the
program's outside the band, summed over the checked epochs (limit 0).

The band cannot see a quantile index off by one, since both neighbours
of xi lie within rounding of it; the CPU tests pin that index exactly
(``portbench/tests/test_portbench_hard_indicator.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.drivers import common, train
from portbench.reference.common import Prec


def follow(cell, data, order, prog: list, prec: Prec, fault=None) -> tuple:
    """The reference's states before and after each checked epoch, taking
    the program's z (``prog``, its snapshots) in the band; and per epoch
    ``(band users, z outside the band that differ, largest relative loss
    error, users, z taken from the program that differ)``."""
    from portbench.run import load_module

    c, dev = cell.config, cell.device
    tau = cell.limits["tau"]["value"]
    ref = load_module("reference", c["model"])
    users, items = data
    nu, ni = int(users.max()) + 1, int(items.max()) + 1
    prob = ref.Problem(users, items, nu, ni, c["config"], dev, order)
    u0, v0 = train.start_tables(cell, nu, ni)
    state = ref.start_state(prob, u0, v0, prec)
    del u0, v0
    out, stats = [train._ref_snapshot(state)], []
    for k in range(1, len(prog)):
        z_prog = torch.as_tensor(prog[k]["dual_weight"]).to(dev, prec.dtype)
        loss_prog = torch.as_tensor(prog[k]["user_loss"]).to(dev,
                                                             torch.float64)

        def settle(loss, xi, z):
            # users without a history keep their z, and have no loss
            band = prob.present & ((loss - xi).abs() <= tau * torch.maximum(
                loss.abs(), xi.abs()))
            differ = prob.present & (z != z_prog)
            outside = int((differ & ~band).sum())
            ref_loss = loss[prob.present].to(torch.float64)
            rel = float(((loss_prog[prob.present] - ref_loss).abs()
                         / ref_loss.abs()).max())
            stats.append((int(band.sum()), outside, rel,
                          int(prob.present.sum()), int((differ & band).sum())))
            return torch.where(band, z_prog, z)

        state = ref.epoch(prob, state, None, prec, fault, settle=settle)
        out.append(train._ref_snapshot(state))
    return out, stats


def judged(prog: list, follower: list, stats: list) -> dict:
    """The checks: the five leaf gaps and ``z_outside_band``."""
    numbers = train.compare(prog, follower)
    numbers["z_outside_band"] = float(sum(s[1] for s in stats))
    return numbers


def log_band(stats: list) -> None:
    for k, (band, outside, rel, n, taken) in enumerate(stats, 1):
        common.log(f"checked epoch {k}: {band} of {n} users in the band "
                   f"({100.0 * band / n:.4f}%), {taken} of them with the "
                   f"program's z against the follower's own; {outside} z "
                   f"outside it differ; largest relative loss error "
                   f"{rel:.3e}")


def run(cell) -> dict:
    from portbench.run import device_info, load_module

    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data, order, dd, model, snaps = train.setup(cell)
    t0 = common.now(dev)
    setup_s = time.time() - cell.t_start
    epochs = 0
    while True:
        model.train_epochs(dd, 1)
        epochs += 1
        t1 = common.now(dev)
        if t1 - t0 >= cell.seconds:
            break
    window = t1 - t0
    users = dd.num_users
    yard = load_module("flops", cell.config["flops"])
    lens_u = np.bincount(data[0], minlength=dd.num_users)
    lens_i = np.bincount(data[1], minlength=dd.num_items)
    cfg = cell.config["config"]
    trace = None
    if cell.trace:
        n = cell.traffic["trace_epochs"]
        trace = common.traced(lambda: (model.train_epochs(dd, n), n)[1], dev)
        trace.update(main_window_s=window, main_units=epochs,
                     unit_flops=yard.epoch_flops(cfg, lens_u, lens_i),
                     unit_bytes=yard.epoch_bytes(cfg, lens_u, lens_i))
    info = device_info(cell.device, 1)
    del model, dd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    ref, stats = follow(cell, data, order, snaps, Prec(torch.float64))
    log_band(stats)
    numbers = judged(snaps, ref, stats)
    common.log(f"window {window:.2f} s, {epochs} epochs; reference "
               f"{time.time() - t_ref:.1f} s")
    return {"e2e": {"train_users_per_s": users * epochs / window,
                    "setup_s": setup_s},
            "numbers": numbers, "attempted": epochs, "failed": 0,
            "device": info, "trace": trace}
