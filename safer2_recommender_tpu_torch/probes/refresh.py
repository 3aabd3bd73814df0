"""The JAX package's warm eigenbasis refresh against the port's default
full eigh, epoch by epoch on the GPU: how far the warm branch moves an
epoch, and what each branch costs there.

    python -m safer2_recommender_tpu_torch.probes.eigh --part refresh

From one trained state (trained at the port's default,
``eig_refresh_tol`` 0), the model is cloned and the next epoch runs
twice: once at the JAX package's 0.08 (``config.JAX_EIG_REFRESH_TOL``)
and once at 0. For each run, every eigenbasis the epoch computed
(``woodbury.maybe_eigh``, in the order the sweeps ask for them): the
branch it took (``warm`` or ``cold`` by ``woodbury.SOLVE_PATHS``, or
``full`` where tol 0 skips the refresh), the carried basis's coupling
share ``||B - blkdiag_128(B)||_F / ||B||_F`` of ``B = Q_prev^T G
Q_prev`` (what the warm branch's test compares with the tolerance,
computed as ``refresh_eigh`` computes it), and its ms by CUDA events
(the branch test's host read and the eigh's ``info`` read included);
then the max abs and max rel (of the table's max |entry|) difference of
U and of V between the two runs. ``WORKLOADS``, all at dim 512:

- ``ml1m``: SAFER2 on the bundled ML-1M split at the README config;
  forks after each epoch of ``ML1M_AFTER``, then ``ML1M_EPOCHS`` epochs
  at each tolerance from the same initial tables: NDCG@20 and Recall@20
  on the validation fold, the mean dual weight after each epoch and the
  warm refreshes of each epoch (the evaluation's fold-in counted
  apart);
- ``synth50k``: SAFER2, iALS and iALS++ (block 64) on the 50k x 40k
  power-law set at the MSD config of ``bench.py:114-117``; forks after
  each epoch of ``SYNTH_AFTER``;
- ``msd``: SAFER2 and iALS on the full synthetic MSD set (571,355 x
  41,140, ``probes/scale.py``'s set-up); forks after each epoch of
  ``MSD_AFTER``.

``check`` fails a run whose tables are not finite, a default epoch that
took a warm refresh, or a 0.08 refresh whose branch disagrees with its
coupling share. On the CPU (the tests, at small sizes) no ms is read.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from safer2_recommender_tpu_torch import probes
from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
from safer2_recommender_tpu_torch.ops import woodbury

WORKLOADS = ("ml1m", "synth50k", "msd")
# the JAX package's tolerance, then the port's default
TOLS = (JAX_EIG_REFRESH_TOL, 0.0)
ML1M_AFTER = (1, 3, 9)
ML1M_EPOCHS = 10
SYNTH_AFTER = (1, 2)
MSD_AFTER = (1, 2)
MODELS = {"ml1m": ("safer2",), "synth50k": ("safer2", "ials", "ialspp"),
          "msd": ("safer2", "ials")}
ML1M_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "ml-1m")


def coupling_share(gram: torch.Tensor, q_prev: torch.Tensor) -> float:
    """``refresh_eigh``'s coupling test as a share: the off-block norm of
    the rotated Gramian over its norm (warm where it is at most the
    tolerance)."""
    d, bs = gram.shape[0], woodbury._REFRESH_BLOCK
    k = d // bs
    b = q_prev.T @ (gram @ q_prev)
    b = 0.5 * (b + b.T)
    blocks = b.reshape(k, bs, k, bs).permute(0, 2, 1, 3)
    idx = torch.arange(k, device=b.device)
    diag = blocks[idx, idx]
    total = torch.linalg.norm(b)
    coupling = torch.sqrt(torch.clamp(
        torch.square(total) - torch.sum(torch.square(diag)), min=0.0))
    return float(coupling / total)


@contextlib.contextmanager
def recorded_eighs():
    """Each ``woodbury.maybe_eigh`` call that returns a basis, in order:
    {"branch", "share" (None without a carried basis at a refresh
    shape), "events" (CUDA start and end, None on the CPU)}.
    Read the ms with ``eigh_ms`` after a synchronize."""
    calls: List[dict] = []
    real = woodbury.maybe_eigh

    def spy(gram, dim, *, use_cg, q_prev=None, refresh_tol=0.0):
        share = None
        if (q_prev is not None and not use_cg
                and dim >= woodbury._REFRESH_MIN_DIM
                and dim % woodbury._REFRESH_BLOCK == 0):
            share = coupling_share(gram, q_prev)
        before = dict(woodbury.SOLVE_PATHS)
        events = None
        if gram.is_cuda:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = real(gram, dim, use_cg=use_cg, q_prev=q_prev,
                   refresh_tol=refresh_tol)
        if events is not None:
            events[1].record()
        if out is not None:
            branch = ("warm" if woodbury.SOLVE_PATHS["refresh_warm"]
                      > before["refresh_warm"] else "cold"
                      if woodbury.SOLVE_PATHS["refresh_cold"]
                      > before["refresh_cold"] else "full")
            calls.append(dict(branch=branch, share=share, events=events))
        return out

    woodbury.maybe_eigh = spy
    try:
        yield calls
    finally:
        woodbury.maybe_eigh = real


def eigh_ms(calls: List[dict]) -> List[dict]:
    """The calls of ``recorded_eighs`` with their ms (None on the CPU)
    in place of the events."""
    out = []
    for c in calls:
        ev = c["events"]
        out.append(dict({k: v for k, v in c.items() if k != "events"},
                        ms=None if ev is None else ev[0].elapsed_time(ev[1])))
    return out


def clone(model, tol: float):
    """A copy of ``model`` at ``eig_refresh_tol`` ``tol``: its state's
    tensors copied, its generator at the same state; the data
    bookkeeping shared."""
    m = copy.copy(model)
    m.cfg = model.cfg.replace(eig_refresh_tol=tol)
    s = model.state
    m.state = s.replace(**{
        f.name: getattr(s, f.name).clone() for f in dataclasses.fields(s)
        if isinstance(getattr(s, f.name), torch.Tensor)})
    m.generator = torch.Generator(device=model.device)
    m.generator.set_state(model.generator.get_state())
    return m


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """max |a - b| and its ratio to max |b|."""
    err = float((a - b).abs().max())
    return dict(abs=err, rel=err / max(float(b.abs().max()), 1e-30))


def fork(model, dd, after: int) -> dict:
    """The next epoch of ``model`` at each of ``TOLS`` from its current
    state (the model itself is not advanced): per tolerance its eigh
    calls (``eigh_ms``), epoch ms (host clock between synchronizes, the
    coupling readings included) and whether its tables are finite; the
    U and V difference of the 0.08 run from the default's."""
    runs, tables = {}, {}
    for tol in TOLS:
        m = clone(model, tol)
        probes.sync(dd.device)
        t0 = time.perf_counter()
        with recorded_eighs() as calls:
            m.train_epochs(dd, 1)
        probes.sync(dd.device)
        ms = (time.perf_counter() - t0) * 1e3
        s = m.state
        runs[tol] = dict(eighs=eigh_ms(calls), epoch_ms=ms, finite=bool(
            torch.isfinite(s.user_emb).all()
            and torch.isfinite(s.item_emb).all()))
        tables[tol] = (s.user_emb, s.item_emb)
        del m
    jax_tol, default = (tables[t] for t in TOLS)
    return dict(after=after, runs=runs, u=_diff(jax_tol[0], default[0]),
                v=_diff(jax_tol[1], default[1]))


def forks(model, dd, after: Sequence[int], epochs: int = 0) -> dict:
    """Train ``model`` (at its own tolerance) to the last of ``after``
    and ``epochs``, forking after each epoch in ``after``; the warm
    refreshes of each of the model's own epochs and its mean dual weight
    after it."""
    out = dict(forks=[], warm_by_epoch=[], mean_weight=[])
    model.initialize(dd)
    for epoch in range(1, max((*after, epochs)) + 1):
        with recorded_eighs() as calls:
            model.train_epochs(dd, 1)
        out["warm_by_epoch"].append(
            sum(c["branch"] == "warm" for c in calls))
        out["mean_weight"].append(model.get_mean_weight())
        if epoch in after:
            out["forks"].append(fork(model, dd, epoch))
    return out


def ml1m_data(device):
    """(Dataset, DeviceData, FoldInData, Config): the bundled ML-1M
    split at the README config, dim 512 (``epoch_profile.ml1m_config``)."""
    from safer2_recommender_tpu_torch.data.dataset import (Dataset,
                                                           DeviceData,
                                                           FoldInData)
    from safer2_recommender_tpu_torch.probes import epoch_profile

    cfg = epoch_profile.ml1m_config()
    train, tr, te = (Dataset.from_csv(os.path.join(ML1M_DIR, f))
                     for f in ("train.csv", "validation_tr.csv",
                               "validation_te.csv"))
    dd = DeviceData.build(train, device=device, dim=cfg.dim)
    fold = FoldInData.build(tr, te, num_items=train.num_items,
                            device=device, dim=cfg.dim)
    return train, dd, fold, cfg


def quality(model, fold) -> dict:
    """NDCG@20 and Recall@20 of ``model`` on ``fold``, and the warm
    refreshes its fold-in took."""
    with recorded_eighs() as calls:
        res = model.evaluate_dataset(fold)
    k = list(res.k_list).index(20)
    return dict(ndcg20=float(res.mean_ndcg()[k]),
                recall20=float(res.mean_recall()[k]),
                fold_in_warm=sum(c["branch"] == "warm" for c in calls))


def run_ml1m(device, data=None, after=ML1M_AFTER,
             epochs: int = ML1M_EPOCHS) -> List[dict]:
    """SAFER2 on ML-1M: the forks of a default run, and ``epochs`` at
    each tolerance from the same initial tables with their quality."""
    from safer2_recommender_tpu_torch.models import get_model

    ds, dd, fold, cfg = data or ml1m_data(device)
    runs = {}
    for tol in reversed(TOLS):       # the default first: it forks
        model = get_model("safer2", cfg.replace(eig_refresh_tol=tol),
                          ds.num_users, ds.num_items, device=device)
        runs[tol] = forks(model, dd, after if tol == 0.0 else (), epochs)
        runs[tol].update(quality(model, fold), epochs=epochs)
        del model
    default = runs[0.0]
    return [dict(workload="ml1m", model="safer2", dim=cfg.dim,
                 forks=default.pop("forks"),
                 warm_by_epoch=default["warm_by_epoch"],
                 mean_weight=default["mean_weight"],
                 quality={t: {k: v for k, v in r.items() if k != "forks"}
                          for t, r in runs.items()})]


def run_models(workload: str, data, device, models: Sequence[str],
               after: Sequence[int]) -> List[dict]:
    """Each of ``models`` on ``data`` = (Dataset, DeviceData, Config) at
    its config: the forks of a default run."""
    from safer2_recommender_tpu_torch.models import get_model

    ds, dd, cfg = data
    rows = []
    for name in models:
        model = get_model(name, cfg.replace(eig_refresh_tol=0.0),
                          dd.num_users, dd.num_items, device=device)
        rows.append(dict(workload=workload, model=name, dim=cfg.dim,
                         **forks(model, dd, after)))
        del model
    return rows


def run(device="cuda", workloads: Sequence[str] = WORKLOADS,
        data: Optional[Dict[str, tuple]] = None) -> List[dict]:
    """The rows of ``workloads`` on ``device``; ``data`` may hold a
    workload's data already built (``ml1m_data``'s tuple, or
    (Dataset, DeviceData, Config) for the others)."""
    from safer2_recommender_tpu_torch.probes import epoch_profile, scale

    data = dict(data or {})
    rows = []
    for wl in workloads:
        if wl == "ml1m":
            rows += run_ml1m(device, data.get("ml1m"))
            continue
        if wl not in data:
            if wl == "synth50k":
                data[wl] = epoch_profile.workload("synth50k", device)
            else:
                w = scale.build(scale.MSD_USERS, scale.MSD_ITEMS,
                                epoch_profile.DIM, device)
                data[wl] = (w.ds, w.dd, w.cfg)
        rows += run_models(wl, data.pop(wl), device, MODELS[wl],
                           SYNTH_AFTER if wl == "synth50k" else MSD_AFTER)
    return rows


def check(row: dict) -> List[str]:
    """What is wrong with a row: tables not finite, a warm refresh at
    the default, a 0.08 refresh whose branch its coupling share does not
    give."""
    bad = []
    for f in row["forks"]:
        for tol, r in f["runs"].items():
            tag = f"{row['workload']} {row['model']} after {f['after']}"
            if not r["finite"]:
                bad.append(f"{tag} tol {tol}: tables not finite")
            for c in r["eighs"]:
                if tol == 0.0 and c["branch"] != "full":
                    bad.append(f"{tag}: a default eigh took {c['branch']}")
                if tol > 0 and c["share"] is not None and (
                        c["branch"] == "warm") != (c["share"] <= tol):
                    bad.append(f"{tag}: {c['branch']} refresh at share "
                               f"{c['share']:.4g}")
    if any(row["warm_by_epoch"]) or row.get("quality", {}).get(
            0.0, {}).get("fold_in_warm"):
        bad.append(f"{row['workload']} {row['model']}: the default run "
                   "took a warm refresh")
    return bad


def _eighs(r: dict) -> str:
    def one(c):
        share = "-" if c["share"] is None else f"{c['share']:.4f}"
        ms = "not measured (CPU)" if c["ms"] is None else f"{c['ms']:.3f} ms"
        return f"{c['branch']} (share {share}, {ms})"

    return ", ".join(one(c) for c in r["eighs"])


def describe(row: dict) -> List[str]:
    lines = []
    for f in row["forks"]:
        runs = f["runs"]
        lines.append(
            f"{row['workload']} {row['model']} dim {row['dim']}, the next "
            f"epoch after {f['after']}: "
            + "; ".join(f"tol {tol:g}: eighs {_eighs(r)}, epoch "
                        f"{r['epoch_ms']:.1f} ms" for tol, r in runs.items())
            + f"; tol {TOLS[0]:g} - tol 0: U max abs {f['u']['abs']:.3e} "
            f"(rel {f['u']['rel']:.3e}), V max abs {f['v']['abs']:.3e} "
            f"(rel {f['v']['rel']:.3e})")
    for tol, q in row.get("quality", {}).items():
        lines.append(
            f"{row['workload']} {row['model']} dim {row['dim']}, "
            f"{q['epochs']} epochs at tol {tol:g}: NDCG@20 "
            f"{q['ndcg20']:.4f}, Recall@20 "
            f"{q['recall20']:.4f}, mean dual weight "
            f"{[round(w, 4) for w in q['mean_weight']]}, warm refreshes by "
            f"epoch {q['warm_by_epoch']} (+{q['fold_in_warm']} in the "
            f"evaluation's fold-in)")
    return lines
