"""Held-out evaluation at scale: the counterpart of the JAX package's
``scripts/bench_eval.py`` and ``scripts/bench_eval_50k.py``.

    python -m safer2_recommender_tpu_torch.probes.eval_scale \\
        [--part ml1m|msd|all] [--dims 32 256 512] [--num_users N]
        [--num_items M] [--heldout H] [--dim D] [--models ...]
        [--device D]

(a) ``ml1m``: the bundled ML-1M fold (``tests/ml-1m``) at each of
``--dims`` for SAFER2 and SAFER2++ (block 64) at the README config, one
epoch after ``initialize``: the first ``evaluate_dataset`` call, then
the median of 3, and NDCG@20.

(b) ``msd``: the MSD protocol's held-out fold, 50,000 users against the
catalog (reference scripts/generate_data.py: ``n_heldout_users=50000``),
built as ``bench_eval_50k.py::heldout_fold`` builds it (``heldout_fold``
here), evaluated by each of ``--models`` trained (``initialize`` + one
epoch) on ``probes/scale.py``'s workload (default
its full 571,355 x 41,140 size, dim 512). Per model: the first and the
warm ``evaluate_dataset`` ms, the warm run split into the fold-in
(``_fold_in``) and the scoring with its metrics (``_eval_metrics``),
each up to a synchronize; ``chol_inverse`` launches of the fold-in;
the peak device memory; Recall@20 / NDCG@20 (synthetic data: no gate,
but finite and in [0, 1]). Then ``subfold_check``: the first 2,048
held-out users evaluated again as a fold of their own must give the
same per-user Recall@20 / NDCG@20 as the whole fold, but where a row's
top 20 differs only by swaps within ``TIE_TOL`` of its top score.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.data.dataset import (Dataset, DeviceData,
                                                       FoldInData)
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.evaluation.metrics import (_mask_history,
                                                             _ranked_ids)
from safer2_recommender_tpu_torch.models import MODEL_REGISTRY, get_model
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.probes import epoch_profile, scale
from safer2_recommender_tpu_torch.probes.serving_scale import (TIE_TOL,
                                                               swaps_are_ties)
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       f32_matmul,
                                                       resolve_device)

ML1M = os.path.dirname(epoch_profile.ML1M_TRAIN)
ML1M_DIMS = (32, 256, 512)
ML1M_MODELS = ("safer2", "safer2pp")
# the MSD protocol's held-out users; the fold's own draw and split seeds
# (bench_eval_50k.py:26-37)
N_HELDOUT, FOLD_SEED, SPLIT_SEED, TE_SHARE = 50_000, 123, 5, 0.2
MSD_MODELS = ("safer2", "ialspp")
SUB_USERS = 2048
K = 20


def heldout_split(n_heldout: int, num_items: int) -> Tuple[Dataset, Dataset]:
    """The held-out users' fold-in (tr) and ground-truth (te) tuples:
    ``powerlaw_dataset(n_heldout, num_items, seed=123)`` split by a
    per-tuple 20% te mask from ``default_rng(5)``."""
    users, items = powerlaw_dataset(n_heldout, num_items, seed=FOLD_SEED)
    te_mask = np.random.default_rng(SPLIT_SEED).random(users.size) < TE_SHARE
    return (Dataset(users[~te_mask], items[~te_mask]),
            Dataset(users[te_mask], items[te_mask]))


def heldout_fold(n_heldout: int, num_items: int, dim: int,
                 device=DEFAULT_DEVICE):
    """``(FoldInData, tr, te)`` of ``heldout_split`` against a catalog of
    ``num_items``, bucketed for ``dim``."""
    tr, te = heldout_split(n_heldout, num_items)
    return (FoldInData.build(tr, te, num_items=num_items, device=device,
                             dim=dim), tr, te)


def evaluate(model, fold: FoldInData) -> dict:
    """``evaluate_dataset`` timed (first call, then warm), and the warm
    run split into its fold-in and its scoring + metrics, each up to a
    synchronize; ``chol_inverse`` launches of one fold-in; peak device
    memory over the three."""
    device = model.device
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    res, first_ms = probes.timed(lambda: model.evaluate_dataset(fold),
                                 device)
    res, warm_ms = probes.timed(lambda: model.evaluate_dataset(fold),
                                device)
    with f32_matmul():
        pf = model._permute_fold(fold)
        before = dict(block_chol.LAUNCHES)
        ue, fold_ms = probes.timed(lambda: model._fold_in(model.state, pf),
                                   device)
        launches = {r: block_chol.LAUNCHES[r] - n for r, n in before.items()}
        (rec, ndcg), score_ms = probes.timed(lambda: model._eval_metrics(
            ue, model.state.item_emb, pf, k_list=res.k_list), device)
    keep = (pf.gt_len > 0).cpu().numpy()
    col = res.k_list.index(K)
    r20, n20 = res.recall[:, col], res.ndcg[:, col]
    return dict(
        result=res, ue=ue, first_ms=first_ms, warm_ms=warm_ms,
        fold_in_ms=fold_ms, scoring_ms=score_ms, fold_in_launches=launches,
        split_equal=bool(np.array_equal(rec.cpu().numpy()[keep], res.recall)
                         and np.array_equal(ndcg.cpu().numpy()[keep],
                                            res.ndcg)),
        users=int(res.recall.shape[0]),
        recall20=float(r20.mean()), ndcg20=float(n20.mean()),
        in_range=bool(np.isfinite(res.recall).all()
                      and np.isfinite(res.ndcg).all()
                      and ((res.recall >= 0) & (res.recall <= 1)).all()
                      and ((res.ndcg >= 0) & (res.ndcg <= 1)).all()),
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if on_card else None))


def _top_ids(model, ue: torch.Tensor, excl: torch.Tensor) -> torch.Tensor:
    """Top-K solver-order ids of each row of ``ue``, history masked."""
    with f32_matmul():
        return _ranked_ids(_mask_history(ue @ model.state.item_emb.T, excl),
                           K)


def subfold_check(model, tr: Dataset, te: Dataset, fold: FoldInData,
                  full: dict, n_sub: int = SUB_USERS) -> dict:
    """The first ``n_sub`` held-out users of ``fold`` (tr, te) evaluated
    as a fold of their own against ``full`` (``evaluate(model, fold)``):
    their per-user Recall@K / NDCG@K must equal those rows of the whole
    fold's. A row that differs is excused only if the two top-K lists
    (each from its own fold-in) differ by swaps of items whose scores,
    under the whole fold's fold-in, lie within ``TIE_TOL`` of the row's top
    score (equal lists excuse nothing). Returns the rows compared, those
    that differ and those excused."""
    sel = np.unique(tr.user_ids)[:n_sub]
    m_tr, m_te = np.isin(tr.user_ids, sel), np.isin(te.user_ids, sel)
    sub = FoldInData.build(
        Dataset(tr.user_ids[m_tr], tr.item_ids[m_tr]),
        Dataset(te.user_ids[m_te], te.item_ids[m_te]),
        num_items=fold.num_items, device=model.device, dim=model.cfg.dim)
    sres = model.evaluate_dataset(sub)
    res = full["result"]
    col = res.k_list.index(K)
    n = sres.recall.shape[0]
    differ = np.flatnonzero(
        (sres.recall[:, col] != res.recall[:n, col])
        | (sres.ndcg[:, col] != res.ndcg[:n, col]))
    excused = 0
    if differ.size:
        # result rows are the fold rows with ground truth, in order
        pf = model._permute_fold(fold)
        psub = model._permute_fold(sub, cache=False)
        rows = torch.as_tensor(
            np.flatnonzero((pf.gt_len > 0).cpu().numpy())[differ],
            device=model.device)
        with f32_matmul():
            ue_sub = model._fold_in(model.state, psub)
        ue_full = full["ue"][rows]
        a = _top_ids(model, ue_full, pf.excl[rows]).cpu().numpy()
        b = _top_ids(model, ue_sub[rows], psub.excl[rows]).cpu().numpy()
        with f32_matmul():
            scores = (ue_full @ model.state.item_emb.T).cpu().numpy()
        excused = sum(not np.array_equal(x, y) and swaps_are_ties(s, x, y)
                      for s, x, y in zip(scores, a, b))
    return dict(rows=int(n), differ=int(differ.size), excused=int(excused))


def describe(tag: str, r: dict) -> str:
    peak = ("not measured (CPU)" if r["peak_bytes"] is None
            else f"{r['peak_bytes']} B")
    return (f"{tag}: {r['users']} users with ground truth; evaluate_dataset "
            f"first {r['first_ms']:.1f} ms, warm {r['warm_ms']:.1f} ms; warm "
            f"split: fold-in {r['fold_in_ms']:.1f} ms (chol_inverse "
            f"launches by r {r['fold_in_launches']}), scoring + metrics "
            f"{r['scoring_ms']:.1f} ms (split equal to evaluate_dataset: "
            f"{r['split_equal']}); Recall@{K} {r['recall20']:.4f}, "
            f"NDCG@{K} {r['ndcg20']:.4f} (finite, in [0, 1]: "
            f"{r['in_range']}); peak device memory {peak}")


def run_ml1m(dims: Sequence[int], device) -> Dict:
    """(a): the ML-1M fold at each dim, each of ``ML1M_MODELS``."""
    train = Dataset.from_csv(os.path.join(ML1M, "train.csv"))
    val_tr = Dataset.from_csv(os.path.join(ML1M, "validation_tr.csv"))
    val_te = Dataset.from_csv(os.path.join(ML1M, "validation_te.csv"))
    out = {}
    for dim in dims:
        dd = DeviceData.build(train, device=device, dim=dim)
        fold = FoldInData.build(val_tr, val_te, num_items=train.num_items,
                                device=device, dim=dim)
        for name in ML1M_MODELS:
            cfg = epoch_profile.ml1m_config().replace(
                dim=dim, block_size=min(scale.BLOCK, dim))
            m = get_model(name, cfg, train.num_users, train.num_items,
                          device=device)
            m.initialize(dd)
            m.train_epoch(dd)
            res, first = probes.timed(lambda: m.evaluate_dataset(fold),
                                      device)
            times = [probes.timed(lambda: m.evaluate_dataset(fold),
                                  device)[1] for _ in range(3)]
            out[name, dim] = dict(first_ms=first,
                                  median_ms=statistics.median(times),
                                  ndcg20=float(res.mean_ndcg()[2]),
                                  users=fold.n_eval)
            print(f"[eval-ml1m] {name} dim {dim}: evaluate_dataset first "
                  f"{first:.1f} ms, median of 3 "
                  f"{out[name, dim]['median_ms']:.1f} ms; NDCG@20 "
                  f"{out[name, dim]['ndcg20']:.4f} ({fold.n_eval} users)",
                  flush=True)
    return out


def run_msd(wl: scale.Workload, models: Sequence[str],
            n_heldout: int = N_HELDOUT, trained: Optional[dict] = None,
            n_sub: int = SUB_USERS) -> Dict[str, dict]:
    """(b): the held-out fold against ``wl``'s catalog, evaluated by each
    of ``models`` (taken from ``trained`` by name where given, else
    trained here for one epoch by ``scale.train``)."""
    device = wl.dd.device
    t0 = time.perf_counter()
    fold, tr, te = heldout_fold(n_heldout, wl.dd.num_items, wl.cfg.dim,
                                device)
    probes.sync(device)
    build_s = time.perf_counter() - t0
    print(f"[eval-msd] fold: {n_heldout} held-out users, {tr.nnz} tr / "
          f"{te.nnz} te tuples, catalog {wl.dd.num_items}, {len(fold.by_user)}"
          f" fold-in buckets, excl {list(fold.excl.shape)} / gt "
          f"{list(fold.gt.shape)} int64 ({fold.excl.numel() * 8} / "
          f"{fold.gt.numel() * 8} B); built in {build_s:.2f} s", flush=True)
    out = {}
    for name in models:
        model = (trained or {}).get(name)
        if model is None:
            model = scale.train(wl, name, epochs=0)["model"]
        r = evaluate(model, fold)
        print(f"[eval-msd] {describe(name, r)}", flush=True)
        r["subfold"] = subfold_check(model, tr, te, fold, r, n_sub)
        sf = r["subfold"]
        print(f"[eval-msd] {name}: the first {n_sub} held-out users as a "
              f"fold of their own: {sf['rows']} rows, {sf['differ']} with "
              f"another Recall@{K} / NDCG@{K}, of them {sf['excused']} a "
              f"near-tie swap (TIE_TOL {TIE_TOL:g})", flush=True)
        del r["ue"], r["result"]
        out[name] = r
        del model
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("ml1m", "msd", "all"), default="all")
    ap.add_argument("--dims", type=int, nargs="+", default=list(ML1M_DIMS))
    ap.add_argument("--num_users", type=int, default=scale.MSD_USERS)
    ap.add_argument("--num_items", type=int, default=scale.MSD_ITEMS)
    ap.add_argument("--heldout", type=int, default=N_HELDOUT)
    ap.add_argument("--dim", type=int, default=scale.DIM)
    ap.add_argument("--models", nargs="+", default=list(MSD_MODELS),
                    choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(device), flush=True)
    ok = True
    if args.part in ("ml1m", "all"):
        run_ml1m(args.dims, device)
    if args.part in ("msd", "all"):
        wl = scale.build(args.num_users, args.num_items, args.dim, device)
        print(f"[eval-msd] training set: {scale.describe_workload(wl)}",
              flush=True)
        res = run_msd(wl, args.models, args.heldout,
                      n_sub=min(SUB_USERS, args.heldout))
        ok = all(r["in_range"] and r["subfold"]["differ"]
                 == r["subfold"]["excused"] for r in res.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
