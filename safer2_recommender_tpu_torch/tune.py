"""Random-search hyperparameter tuning over the validation split (the
port's counterpart of ``scripts/tune.py``, on the port's library API).

The reference lists optuna in scripts/requirements.txt but ships no
tuning script; this is the missing piece, with no external
dependencies. Each trial trains a model on the train split and scores
mean NDCG@20 on the validation fold-in protocol (the same metric the
README's tuned configs optimize). It runs on the card unless
``--device cpu`` is given.

    python -m safer2_recommender_tpu_torch.tune --model_name safer2 \
        --train_data .../train.csv --test_train_data .../validation_tr.csv \
        --test_test_data .../validation_te.csv \
        --trials 20 --epoch 10 --dim 32 [--out best.json] [--device cpu]

Search spaces are log-uniform over the ranges spanned by the README's
per-dataset tuned configs; fixed flags (--dim, --alpha, ...) pin that
hyperparameter instead of searching it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData,
                                          FoldInData, get_model)
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       DeviceUnavailable,
                                                       resolve_device)

# log-uniform ranges spanning the README's tuned configs across datasets
SEARCH_SPACE = {
    "uobs_weight": (1e-4, 0.5),
    "l2_reg": (1e-4, 0.02),
    "bandwidth": (0.05, 1.0),     # safer family only
    "stepsize": (0.05, 1.0),      # cvar_mf only
}
SAFER_ONLY = {"bandwidth"}
CVAR_ONLY = {"stepsize"}


def sample(space, rng, model_name, pinned):
    cfg = {}
    for name, (lo, hi) in space.items():
        if name in pinned:
            cfg[name] = pinned[name]
            continue
        if name in SAFER_ONLY and model_name not in (
                "safer2", "safer2pp", "cvar_mf", "erm_mf"):
            continue
        if name in CVAR_ONLY and model_name != "cvar_mf":
            continue
        cfg[name] = float(math.exp(rng.uniform(
            math.log(lo), math.log(hi))))
    return cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_name", required=True)
    p.add_argument("--train_data", required=True)
    p.add_argument("--test_train_data", required=True)
    p.add_argument("--test_test_data", required=True)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--alpha", type=float, default=0.3)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metric_k", type=int, default=20,
                   help="optimize mean NDCG@this (README tunes NDCG@20)")
    p.add_argument("--out", default="",
                   help="write best config + all trials as JSON here")
    # pin any searched hyperparameter by passing it explicitly
    p.add_argument("--uobs_weight", type=float, default=None)
    p.add_argument("--l2_reg", type=float, default=None)
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--stepsize", type=float, default=None)
    # addition of the port
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to run on (default cuda; fails when "
                        "CUDA is absent rather than fall back to the CPU)")
    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except DeviceUnavailable as e:
        p.error(f"--device {args.device}: {e}")

    train = Dataset.from_csv(args.train_data)
    dd = DeviceData.build(train, device=device, dim=args.dim)
    fold = FoldInData.build(Dataset.from_csv(args.test_train_data),
                            Dataset.from_csv(args.test_test_data),
                            num_items=train.num_items, device=device,
                            dim=args.dim)
    k_list = sorted({5, 10, args.metric_k})
    k_idx = k_list.index(args.metric_k)

    pinned = {k: getattr(args, k) for k in SEARCH_SPACE
              if getattr(args, k) is not None}
    rng = np.random.default_rng(args.seed)
    trials, best = [], None
    for t in range(args.trials):
        hp = sample(SEARCH_SPACE, rng, args.model_name, pinned)
        cfg = Config(dim=args.dim, alpha=args.alpha,
                     block_size=args.block_size, epochs=args.epoch,
                     seed=args.seed + t, **hp)
        model = get_model(args.model_name, cfg, train.num_users,
                          train.num_items, device=device)
        model.initialize(dd)
        t0 = time.perf_counter()
        model.train_epochs(dd, args.epoch)
        res = model.evaluate_dataset(fold, k_list=k_list)
        score = float(res.mean_ndcg()[k_idx])
        rec = {"trial": t, "score": score, "hyperparams": hp,
               "train_s": round(time.perf_counter() - t0, 2)}
        trials.append(rec)
        if best is None or score > best["score"]:
            best = rec
        print(json.dumps(rec))

    print(json.dumps({"best": best,
                      "metric": f"mean_ndcg@{args.metric_k}"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"best": best, "trials": trials,
                       "metric": f"mean_ndcg@{args.metric_k}"}, f,
                      indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
