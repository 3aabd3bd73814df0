"""Serving new users against the catalog: the counterpart of the JAX
package's ``scripts/bench_serving.py``.

    python -m safer2_recommender_tpu_torch.probes.serving_scale \\
        [model] [dim] [batch_users] [--num_users N] [--num_items M]
        [--device D]

Trains ``model`` (default SAFER2, dim 512) for one epoch after
``initialize`` on ``probes/scale.py``'s workload (default 50,000 x
40,000, as the JAX script), then draws ``batch_users`` (default 8,192)
new users exactly as ``bench_serving.py`` does (``new_users``:
``default_rng(7)``, log-normal(ln 20, 0.8) history lengths clipped to
3-500, zipf-0.8 items) and times ``recommend(batch, k=100)``, exact and
``approx=True``: the first call, then the best of 3, and users/s
(fold-in + scoring + top-k + id decode + the copy to the host). Then
the port's fixed-shape ``serving.py::Server`` (k = 100) on the same
batch: its first call (which captures its CUDA graphs on the card), its
p50 ms, and its ids against the exact ``recommend()``'s, which must be
equal but for swaps of near-tied items (``tie_rows``: ROADMAP Queue 3,
a Server pads a batch to rung widths and ``recommend()`` to length
buckets, so the reductions over the history axis round differently).
Both are checked for ids in range and outside each user's history.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.data.dataset import Dataset, FoldInData
from safer2_recommender_tpu_torch.models import MODEL_REGISTRY
from safer2_recommender_tpu_torch.probes import scale
from safer2_recommender_tpu_torch.serving import Server
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       f32_matmul,
                                                       resolve_device)

BATCH, K, SEED = 8192, 100, 7
TRAIN_USERS, TRAIN_ITEMS = 50_000, 40_000
P50_REPEATS = 5
# A served row may swap two items whose scores under recommend()'s own
# fold-in lie within TIE_TOL of the row's top score (ROADMAP Queue 3): a
# Server pads a batch to its rung widths, recommend() to its length
# buckets, and the reductions over the padded history axis round
# differently (one such swap in ~1,500 rows of the interleaved dim-512
# SAFER2++, scores 7e-7 apart). Any other difference is a fault.
TIE_TOL = 1e-5


def new_users(n: int, num_items: int, seed: int = SEED) -> Dataset:
    """``n`` new users' histories over ``num_items`` items, drawn as
    ``bench_serving.py:44-53`` and ``bench.py::_serve_batch`` draw them
    (``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    hist_len = np.clip(rng.lognormal(np.log(20), 0.8, n), 3,
                       500).astype(np.int64)
    pop = 1.0 / (np.arange(1, num_items + 1) ** 0.8)
    pop /= pop.sum()
    users = np.repeat(np.arange(n, dtype=np.int32), hist_len)
    items = rng.choice(num_items, size=int(hist_len.sum()),
                       p=pop).astype(np.int32)
    return Dataset(users, items)


def swaps_are_ties(score, a, b) -> bool:
    """Do the id lists ``a`` and ``b`` differ only by swaps of items
    whose ``score[id]`` lie within ``TIE_TOL`` of the largest |score| of
    the two lists?"""
    ids = np.union1d(a, b)
    top = max(abs(float(score[x])) for x in ids)
    return all(abs(float(score[x]) - float(score[y])) <= TIE_TOL * top
               for x, y in zip(a.tolist(), b.tolist()) if x != y)


def tie_rows(model, batch: Dataset, got: np.ndarray,
             want: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of the catalog-id lists ``got`` and ``want`` (one row per
    distinct user of ``batch``) that differ, and those of them that
    differ only by near-tie swaps (``swaps_are_ties``) under
    ``recommend()``'s own fold-in of ``batch``."""
    rows = np.flatnonzero((got != want).any(axis=1))
    if rows.size == 0:
        return rows, rows
    empty = Dataset(np.zeros(0, np.int32), np.zeros(0, np.int32))
    fold = model._permute_fold(FoldInData.build(
        batch, empty, num_items=model.num_items, device=model.device,
        dim=model.cfg.dim), cache=False)
    with f32_matmul():
        ue = model._fold_in(model.state, fold)[torch.as_tensor(
            rows, device=model.device)]
        scores = (ue @ model.state.item_emb.T).cpu().numpy()
    perm = (np.arange(model.num_items) if model._item_perm is None
            else model._item_perm.cpu().numpy())
    ties = [j for j, s in zip(rows, scores)
            if swaps_are_ties(s, perm[got[j]], perm[want[j]])]
    return rows, np.asarray(ties, np.int64)


def bad_ids(batch: Dataset, users: np.ndarray, ids: np.ndarray,
            num_items: int) -> Tuple[int, int]:
    """(ids out of [0, num_items), recommended ids in the user's own
    history) of ``ids`` [len(users), k]."""
    out_of_range = int(((ids < 0) | (ids >= num_items)).sum())
    hist = batch.user_ids.astype(np.int64) * num_items + batch.item_ids
    rec = users.astype(np.int64)[:, None] * num_items + ids
    return out_of_range, int(np.isin(rec, hist).sum())


def serve(model, batch: Dataset) -> dict:
    """``recommend(batch, K)`` exact and approx (first call, best of 3),
    then a ``Server(model, K)`` on the same batch (first call, p50 of
    ``P50_REPEATS``), with the checks of ``bad_ids`` and ``tie_rows``."""
    device = model.device
    n = int(np.unique(batch.user_ids).size)
    out, ids = {"users": n, "k": K}, {}
    for label, approx in (("exact", False), ("approx", True)):
        ids[label], first = probes.timed(
            lambda: model.recommend(batch, k=K, approx=approx), device)
        best = min(probes.timed(
            lambda: model.recommend(batch, k=K, approx=approx), device)[1]
            for _ in range(3))
        out[label] = dict(first_ms=first, best_ms=best,
                          users_per_s=n / best * 1e3,
                          bad=bad_ids(batch, *ids[label], model.num_items))
    want_users, want = ids["exact"]
    srv = Server(model, k=K)
    (got_users, got), first = probes.timed(lambda: srv.recommend(batch),
                                           device)
    times = [probes.timed(lambda: srv.recommend(batch), device)[1]
             for _ in range(P50_REPEATS)]
    rows, ties = tie_rows(model, batch, got, want)
    out["server"] = dict(
        first_ms=first, p50_ms=statistics.median(times),
        users_per_s=n / statistics.median(times) * 1e3,
        graphs=srv.num_compiles,
        users_equal=bool(np.array_equal(got_users, want_users)),
        bad=bad_ids(batch, got_users, got, model.num_items),
        differ=int(rows.size), near_tie=int(ties.size))
    return out


def describe(tag: str, r: dict) -> str:
    parts = [f"{tag}: {r['users']} new users, k={r['k']}"]
    for label in ("exact", "approx"):
        e = r[label]
        parts.append(f"recommend() {label} first {e['first_ms']:.1f} ms, "
                     f"best of 3 {e['best_ms']:.1f} ms = "
                     f"{e['users_per_s']:.0f} users/s (out of range, in "
                     f"history: {e['bad']})")
    s = r["server"]
    parts.append(f"Server first call {s['first_ms']:.1f} ms ({s['graphs']} "
                 f"programs), p50 of {P50_REPEATS} {s['p50_ms']:.1f} ms = "
                 f"{s['users_per_s']:.0f} users/s (out of range, in history:"
                 f" {s['bad']}); ids equal to recommend()'s in "
                 f"{r['users'] - s['differ']} of {r['users']} rows, "
                 f"{s['near_tie']} of the other {s['differ']} a near-tie "
                 f"swap (TIE_TOL {TIE_TOL:g})")
    return "; ".join(parts)


def ok(r: dict) -> bool:
    """The gates: no id out of range or in the history, the Server's
    users and ids those of ``recommend()`` but for near-tie swaps."""
    s = r["server"]
    return (r["exact"]["bad"] == (0, 0) and r["approx"]["bad"] == (0, 0)
            and s["bad"] == (0, 0) and s["users_equal"]
            and s["differ"] == s["near_tie"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model", nargs="?", default=scale.MODEL,
                    choices=sorted(MODEL_REGISTRY))
    ap.add_argument("dim", type=int, nargs="?", default=scale.DIM)
    ap.add_argument("batch_users", type=int, nargs="?", default=BATCH)
    ap.add_argument("--num_users", type=int, default=TRAIN_USERS)
    ap.add_argument("--num_items", type=int, default=TRAIN_ITEMS)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(device), flush=True)
    wl = scale.build(args.num_users, args.num_items, args.dim, device)
    print(f"[serving] training set: {scale.describe_workload(wl)}",
          flush=True)
    model = scale.train(wl, args.model, epochs=0)["model"]
    r = serve(model, new_users(args.batch_users, wl.dd.num_items))
    print(f"[serving] {describe(args.model, r)}", flush=True)
    return 0 if ok(r) else 1


if __name__ == "__main__":
    sys.exit(main())
