"""Training traffic: ``Recommender.train_epochs(dd, 1)`` in a loop.

Set-up draws the configuration's training set from the seed, builds the
port's ``DeviceData``, makes the model with ``get_model``, hands it the
benchmark's initial tables (drawn on the card from the seed), runs
``initialize``, seeds the model's generator (its sub-sampled Newton
draws), reads the order in which the program numbers its users, and
runs the first ``checked_epochs`` epochs through the window's own call,
keeping the state after each on the host. The first of them builds
every kernel. The window then runs whole epochs of the same object
until ``--seconds`` have passed; ``train_users_per_s`` is the training
users times the epochs over the time from the window's start to the
synchronize that ends its last epoch.

After the window (and, with ``--trace 1``, a traced window of
``trace_epochs`` epochs) the program is freed and the float64 reference
(``portbench/reference/<model>.py``) follows the checked epochs from the
same tables and the same draws, indexed in the same user order; each
leaf of the state (U, V, the dual weights, xi, the per-user loss) is
compared after every checked epoch.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.drivers import common
from portbench.frozen import synth
from portbench.reference.common import Prec

LEAVES = ("user_emb", "item_emb", "dual_weight", "xi", "user_loss")


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _snapshot(model, dd) -> dict:
    """The model's state in original id order, on the host."""
    s = model.state
    return {"user_emb": _host(s.user_emb[dd.user_perm]),
            "item_emb": _host(s.item_emb[dd.item_perm]),
            "dual_weight": _host(s.dual_weight[dd.user_perm]),
            "xi": np.array([float(s.xi)]),
            "user_loss": _host(s.user_loss[dd.user_perm])}


def _ref_snapshot(st: dict) -> dict:
    """The reference's leaves, left on its device."""
    return {"user_emb": st["user_emb"], "item_emb": st["item_emb"],
            "dual_weight": st["dual_weight"], "xi": st["xi"].reshape(1),
            "user_loss": st["user_loss"]}


def build(cell):
    """(dataset arrays, DeviceData, model) with the benchmark's tables
    and draws handed to the model."""
    from safer2_recommender_tpu_torch.config import Config
    from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
    from safer2_recommender_tpu_torch.models import get_model

    c, dev = cell.config, cell.device
    users, items, _ = synth.training_set(c["dataset"], cell.sub_seed("data"),
                                         dev)
    ds = Dataset(users, items)
    cfg = Config(**c["config"], seed=cell.sub_seed("model") % (1 << 62))
    dd = DeviceData.build(ds, device=dev, dim=cfg.dim)
    model = get_model(c["model"], cfg, ds.num_users, ds.num_items,
                      device=dev)
    u0, v0 = start_tables(cell, ds.num_users, ds.num_items)
    v = v0[dd.item_order].contiguous()
    model.state = model.state.replace(
        user_emb=u0[dd.user_order].contiguous(), item_emb=v,
        item_gramian=v.T @ v)
    del u0, v0
    model.initialize(dd)
    model.generator.manual_seed(cell.sub_seed("draws"))
    return (users, items), dd, model


def setup(cell):
    """Build the program and run its checked epochs through the window's
    own call: (dataset arrays, the program's user order, DeviceData,
    model, the state before and after each checked epoch). The order
    (position -> user id) is the one input the reference takes from the
    program: its sub-sampled Newton draws index users in it."""
    data, dd, model = build(cell)
    common.log(f"built in {time.time() - cell.t_start:.1f} s")
    order = dd.user_order.cpu().numpy()
    snaps = [_snapshot(model, dd)]
    for _ in range(cell.traffic["checked_epochs"]):
        model.train_epochs(dd, 1)
        snaps.append(_snapshot(model, dd))
        common.log(f"checked epoch at {time.time() - cell.t_start:.1f} s")
    return data, order, dd, model, snaps


def start_tables(cell, num_users: int, num_items: int):
    c = cell.config["config"]
    return (common.tables(cell.sub_seed("user_table"), num_users, c["dim"],
                          c["stdev"], cell.device),
            common.tables(cell.sub_seed("item_table"), num_items, c["dim"],
                          c["stdev"], cell.device))


def reference_states(cell, data, order, prec: Prec, fault=None,
                     epochs=None):
    """The reference's state before and after each checked epoch, from
    the benchmark's tables and draws, the users numbered in ``order``."""
    from portbench.run import load_module

    t_start = time.time()
    c, dev = cell.config, cell.device
    ref = load_module("reference", c["model"])
    users, items = data
    nu, ni = int(users.max()) + 1, int(items.max()) + 1
    prob = ref.Problem(users, items, nu, ni, c["config"], dev, order)
    u0, v0 = start_tables(cell, nu, ni)
    state = ref.start_state(prob, u0, v0, prec)
    del u0, v0
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.sub_seed("draws"))
    out = [_ref_snapshot(state)]
    t = time.time()
    common.log(f"reference set up in {t - t_start:.1f} s")
    for _ in range(epochs or cell.traffic["checked_epochs"]):
        state = ref.epoch(prob, state, gen, prec, fault)
        out.append(_ref_snapshot(state))
        common.log(f"reference epoch in {time.time() - t:.1f} s")
        t = time.time()
    return out


def epoch_gaps(prog: list, ref: list) -> list:
    """Per checked epoch, per leaf, ||program - reference|| over
    ||reference - start|| (None where the reference did not move it)."""
    return [common.leaf_gaps(prog[k], ref[k], ref[0])
            for k in range(1, len(ref))]


def compare(prog: list, ref: list) -> dict:
    """Per leaf, the largest over the checked epochs of
    ``epoch_gaps``."""
    worst = {k: None for k in LEAVES}
    for gaps in epoch_gaps(prog, ref):
        for leaf, g in gaps.items():
            if g is not None and (worst[leaf] is None or g > worst[leaf]
                                  or g != g):
                worst[leaf] = g
    return worst


def run(cell) -> dict:
    from portbench.run import device_info, load_module

    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data, order, dd, model, snaps = setup(cell)
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
    flops_fn = load_module("flops", cell.config["flops"]).epoch_flops
    lens_u = np.bincount(data[0], minlength=dd.num_users)
    lens_i = np.bincount(data[1], minlength=dd.num_items)
    epoch_flops = flops_fn(cell.config["config"], lens_u, lens_i)
    trace = None
    if cell.trace:
        n = cell.traffic["trace_epochs"]
        trace = common.traced(lambda: (model.train_epochs(dd, n), n)[1], dev)
        trace.update(main_window_s=window, main_units=epochs,
                     unit_flops=epoch_flops)
    info = device_info(cell.device, 1)
    del model, dd
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    ref = reference_states(cell, data, order, Prec(torch.float64))
    t_cmp = time.time()
    numbers = compare(snaps, ref)
    common.log(f"compared in {time.time() - t_cmp:.1f} s")
    common.log(f"window {window:.2f} s, {epochs} epochs; reference "
               f"{time.time() - t_ref:.1f} s")
    return {"e2e": {"train_users_per_s": users * epochs / window,
                    "setup_s": setup_s},
            "numbers": numbers, "attempted": epochs, "failed": 0,
            "device": info, "trace": trace}
