"""The serving forward step and the multi-device dry run: the
counterparts of the JAX package's ``__graft_entry__.py::entry`` and
``dryrun_multichip``.

    python -m safer2_recommender_tpu_torch.dryrun [n] [--device D]

``entry(device)`` returns ``(forward, args)``: full-catalog scores of a
batch of users and their Recall/NDCG at k = 5, 10, 20, 50, 100
(``evaluation/metrics.py::topk_metrics``), on the JAX entry's inputs.

Trains every model on ``n`` ranks (``parallel.spawn``; default 8, the
card) over the row-sharded data: SAFER2++ in both block orders, SAFER2,
iALS, iALS++, ERM-MF and CVaR-MF, on the JAX dry run's data and
configs. Each rank asserts a finite mean loss and, for the SAFER models,
a mean dual weight within 0.02 of alpha (reference safer2_test.cc:135,
Proposition C.1); the caller asserts that ``n`` ranks ran and that each
saw a world of ``n``. With more ranks than cards every rank runs on the
first card over gloo (``parallel.mesh.placement``), which checks
function only: the ranks share the card.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from safer2_recommender_tpu_torch import parallel
from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.evaluation.metrics import topk_metrics
from safer2_recommender_tpu_torch.models import get_model
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       f32_matmul,
                                                       resolve_device)

# "+inter" is the reference's per-block order (--block_interleaved)
RUNS = ("safer2pp", "safer2pp+inter", "safer2", "ials", "ialspp", "erm_mf",
        "cvar_mf")
SAFER = ("safer2", "safer2pp")
DUAL_TOL = 0.02


ENTRY_K = (5, 10, 20, 50, 100)


def entry(device=DEFAULT_DEVICE):
    """``(forward, args)``: the serving forward step of the flagship model
    (the full-catalog scoring matmul of a batch of users, then history
    masking and top-k metrics, as the evaluation runs per chunk) and its
    inputs, drawn as ``__graft_entry__.py:25-31`` draws them. The ids are
    int64 (torch indexes with int64); their values are the JAX entry's."""
    dev = resolve_device(device)

    def forward(user_emb, item_emb, excl, gt, gt_len):
        with f32_matmul():
            scores = user_emb @ item_emb.T
        return topk_metrics(scores, excl, gt, gt_len, ENTRY_K)

    rng = np.random.default_rng(0)
    b, d, num_items, h, g = 256, 64, 2048, 32, 16
    user_emb = rng.normal(size=(b, d)).astype(np.float32)
    item_emb = rng.normal(size=(num_items, d)).astype(np.float32)
    excl = rng.integers(0, num_items, (b, h)).astype(np.int32)
    gt = rng.integers(0, num_items, (b, g)).astype(np.int32)
    gt_len = np.full((b,), g, np.int32)
    args = tuple(torch.from_numpy(x).to(dev) for x in (user_emb, item_emb))
    args += tuple(torch.from_numpy(x.astype(np.int64)).to(dev)
                  for x in (excl, gt, gt_len))
    return forward, args


def dataset() -> Dataset:
    """The JAX dry run's data: 12,000 draws over 512 users x 64 items,
    duplicates removed (512 users put the SNR-sampled xi's mean dual
    within DUAL_TOL)."""
    rng = np.random.default_rng(0)
    n, num_u, num_i = 12000, 512, 64
    pairs = np.unique(
        np.stack([rng.integers(0, num_u, n), rng.integers(0, num_i, n)], 1),
        axis=0).astype(np.int32)
    return Dataset(pairs[:, 0], pairs[:, 1])


def config(name: str, variant: str) -> Config:
    return Config(dim=16, block_size=8, bandwidth=0.3, alpha=0.3,
                  use_snr=(name == "safer2"), sampling_ratio=0.5,
                  block_interleaved=(variant == "inter"))


def rank_main(mesh) -> dict:
    """Every run of RUNS on this rank: its mean loss and, for the SAFER
    models, its mean dual weight."""
    ds = dataset()
    dd = DeviceData.build(ds, device=mesh.device, mesh=mesh)
    out = {}
    for run in RUNS:
        name, _, variant = run.partition("+")
        cfg = config(name, variant)
        model = get_model(name, cfg, ds.num_users, ds.num_items,
                          device=mesh.device, mesh=mesh)
        model.initialize(dd)
        for _ in range(3 if name in SAFER else 1):
            model.train_epoch(dd)
        loss = float(model.state.user_loss.mean())
        if not np.isfinite(loss):
            raise AssertionError(f"{run}: non-finite loss")
        out[run] = {"loss": loss}
        if name in SAFER:
            mw = model.get_mean_weight()
            if abs(mw - cfg.alpha) >= DUAL_TOL:
                raise AssertionError(f"{run}: mean dual {mw:.4f} vs alpha "
                                     f"{cfg.alpha}")
            out[run]["mean_dual"] = mw
    return {"rank": mesh.rank, "world_size": mesh.world_size,
            "device": str(mesh.device), "runs": out}


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> List[dict]:
    """Run RUNS on ``n_devices`` ranks on ``device``; returns each rank's
    report (rank order). Raises if a rank fails, if fewer than
    ``n_devices`` ranks report, or if one saw another world size."""
    dev, backend = parallel.mesh.placement(n_devices, device)
    ranks = parallel.spawn(rank_main, n_devices, device=dev, backend=backend)
    sizes = [r["world_size"] for r in ranks]
    if len(ranks) != n_devices or sizes != [n_devices] * n_devices:
        raise AssertionError(f"dryrun_multichip: {len(ranks)} ranks reported "
                             f"world sizes {sizes}, wanted {n_devices}")
    return ranks


def describe(ranks: List[dict]) -> str:
    r0 = ranks[0]["runs"]
    devices = sorted({r["device"] for r in ranks})
    shared = len(devices) == 1 and parallel.mesh.shares_a_card(
        len(ranks), devices[0])
    return (f"dryrun_multichip OK on {len(ranks)} ranks "
            f"({', '.join(devices)}; {len(RUNS) - 1}/6 models + interleaved "
            f"safer2pp): mean loss "
            + ", ".join(f"{k} {v['loss']:.4f}" for k, v in r0.items())
            + "; mean dual " + ", ".join(f"{k} {v['mean_dual']:.4f}"
                                         for k, v in r0.items()
                                         if "mean_dual" in v)
            + ("; the ranks share one card: a function check, not scaling"
               if shared else ""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=8)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    args = p.parse_args(argv)
    print(describe(dryrun_multichip(args.n, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
