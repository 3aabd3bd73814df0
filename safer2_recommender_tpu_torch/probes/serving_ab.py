"""Serving readings of one tree of the port, to set a change's ``Server``
beside its parent's on one card: the mixed request batches of
``chip_smoke.py``'s ``[server50k]`` and the new users of its
``[serve-msd]``.

    PYTHONPATH=<tree> python3 <tree of this file>/safer2_recommender_tpu_torch/probes/serving_ab.py [--out FILE]

Run by path, it imports ``safer2_recommender_tpu_torch`` from the tree
first on ``PYTHONPATH``, through names the port has had since its
MSD-scale probes only (``probes/scale.py::build`` and ``train``,
``probes/serving_scale.py::new_users``, ``serve`` and ``describe``,
``serving.Server``), so the same file measures a parent tree. Run it in
each tree in turn in one call, pairs of parent and change with the
side that runs first alternating, each run's readings written to
``<dir>/pair<k>_<parent|change>.json``; then

    python3 <this file> --compare <dir>

prints, for each reading, the medians and quartile spreads of both sides
and the pairs the change won: a gain or a loss is called only where one
side wins at least nine tenths of the pairs and the medians differ by
more than the losing side's spread; anything else is "not resolved".

- ``server50k``: SAFER2 and SAFER2++ at dim 512 on the 50k x 40k
  power-law set at the MSD config, after ``initialize`` and one epoch.
  A ``Server(k=10)`` serves the 256 longest histories and 1,024 random
  users (``default_rng(6)``, as ``[server50k]`` draws them): the first
  pass builds the programs, then ``ROUNDS`` passes are timed, each batch
  from a synchronize to a synchronize. Per batch the median ms; users/s
  of the two batches from those medians; the p50 of ``P50_REPEATS``
  requests of 64 users; the programs built and the replays.
- ``serve_msd``: SAFER2 at dim 512 on the full synthetic MSD set after
  ``initialize`` and one epoch: ``serving_scale.serve`` of 1,000 new
  users (``recommend()`` exact and approx, a ``Server`` at k = 100).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from safer2_recommender_tpu_torch import Server, probes
from safer2_recommender_tpu_torch.data.dataset import Dataset
from safer2_recommender_tpu_torch.probes import scale, serving_scale

SYNTH, DIM = (50_000, 40_000), 512
MODELS = ("safer2", "safer2pp")
SEED = 6                    # chip_smoke.py's SERVE_SEED
LONGEST, RANDOM, SMALL = 256, 1024, 64
ROUNDS, P50_REPEATS = 5, 20
MSD_SERVE_USERS = 1000


def _synced_ms(fn, device) -> float:
    probes.sync(device)
    t0 = time.perf_counter()
    fn()
    probes.sync(device)
    return (time.perf_counter() - t0) * 1e3


def requests(ds: Dataset):
    """``[server50k]``'s requests: the ``LONGEST`` longest histories of
    ``ds`` (ties: the lower id first), ``RANDOM`` random users and
    ``SMALL`` more, drawn without replacement from ``default_rng(SEED)``."""
    sizes = np.bincount(ds.user_ids, minlength=ds.num_users)
    top = np.argsort(-sizes, kind="stable")[:LONGEST]
    m = np.isin(ds.user_ids, top)
    out = [Dataset(ds.user_ids[m], ds.item_ids[m])]
    rng = np.random.default_rng(SEED)
    users = np.unique(ds.user_ids)
    for n in (RANDOM, SMALL):
        m = np.isin(ds.user_ids, rng.choice(users, size=n, replace=False))
        out.append(Dataset(ds.user_ids[m], ds.item_ids[m]))
    return out[:2], out[2]


def server50k(model, batches, b64) -> dict:
    """``model`` served through a ``Server(k=10)`` as the module
    docstring says."""
    srv = Server(model, k=10)
    for b in batches:
        srv.recommend(b)
    built = srv.num_compiles
    dev = model.device
    per = [[_synced_ms(lambda: srv.recommend(b), dev) for b in batches]
           for _ in range(ROUNDS)]
    med = [statistics.median(r[j] for r in per) for j in range(len(batches))]
    users = [int(np.unique(b.user_ids).size) for b in batches]
    srv.recommend(b64)
    p50 = statistics.median(_synced_ms(lambda: srv.recommend(b64), dev)
                            for _ in range(P50_REPEATS))
    out = dict(batch_users=users, batch_ms=med,
               users_per_s=sum(users) / sum(med) * 1e3, p50_ms_batch64=p50,
               programs_after_batches=built, programs=srv.num_compiles,
               replays=srv.replays)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def readings(res: dict) -> dict:
    """One run's readings by name, each with whether higher is better."""
    out = {}
    for name in MODELS:
        r = res[f"server50k_{name}"]
        out.update({f"{name} 256 longest ms": (r["batch_ms"][0], False),
                    f"{name} 1,024 random ms": (r["batch_ms"][1], False),
                    f"{name} users/s": (r["users_per_s"], True),
                    f"{name} p50 at 64 ms": (r["p50_ms_batch64"], False)})
    m = res["serve_msd"]
    out["serve_msd Server p50 ms"] = (m["server"]["p50_ms"], False)
    out["serve_msd recommend() exact ms"] = (m["exact"]["best_ms"], False)
    return out


def _spread(xs) -> float:
    q = statistics.quantiles(xs, n=4)
    return q[2] - q[0]


def compare(pairs) -> list:
    """``pairs``: [(parent run, change run)] as ``main`` writes them.
    One line per reading: medians, spreads, the change's wins, verdict."""
    got = [(readings(p), readings(c)) for p, c in pairs]
    lines = []
    for name, (_, higher) in got[0][0].items():
        ps = [p[name][0] for p, _ in got]
        cs = [c[name][0] for _, c in got]
        wins = sum((c > p) if higher else (c < p) for p, c in zip(ps, cs))
        losses = sum((c < p) if higher else (c > p) for p, c in zip(ps, cs))
        pm, cm = statistics.median(ps), statistics.median(cs)
        psp, csp = _spread(ps), _spread(cs)
        need = 0.9 * len(pairs)
        if wins >= need and abs(cm - pm) > psp:
            verdict = "change better"
        elif losses >= need and abs(cm - pm) > csp:
            verdict = "parent better"
        else:
            verdict = "not resolved"
        lines.append(f"{name}: parent median {pm:.3f} (spread {psp:.3f}), "
                     f"change median {cm:.3f} (spread {csp:.3f}); change "
                     f"won {wins} of {len(pairs)} pairs: {verdict}")
    return lines


def _compare_dir(path: str) -> int:
    pairs = []
    k = 1
    while os.path.exists(os.path.join(path, f"pair{k}_parent.json")):
        with open(os.path.join(path, f"pair{k}_parent.json")) as f:
            parent = json.load(f)
        with open(os.path.join(path, f"pair{k}_change.json")) as f:
            pairs.append((parent, json.load(f)))
        k += 1
    for line in compare(pairs):
        print(f"[serving-ab] {line}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the readings here as JSON")
    ap.add_argument("--compare", metavar="DIR",
                    help="compare the pairs of runs written to DIR")
    args = ap.parse_args(argv)
    if args.compare:
        return _compare_dir(args.compare)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false; this probe "
              "measures an NVIDIA GPU", file=sys.stderr)
        return 1
    import safer2_recommender_tpu_torch as pkg

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    res = {"package": pkg.__file__}
    print(f"[serving-ab] package {pkg.__file__}", flush=True)
    wl = scale.build(*SYNTH, DIM, device)
    batches, b64 = requests(wl.ds)
    for name in MODELS:
        model = scale.train(wl, name, epochs=0)["model"]
        r = res[f"server50k_{name}"] = server50k(model, batches, b64)
        print(f"[serving-ab] server50k {name}: {json.dumps(r)}", flush=True)
        del model
    del wl
    gc.collect()
    torch.cuda.empty_cache()
    wl = scale.build(scale.MSD_USERS, scale.MSD_ITEMS, DIM, device)
    model = scale.train(wl, "safer2", epochs=0)["model"]
    r = res["serve_msd"] = serving_scale.serve(
        model, serving_scale.new_users(MSD_SERVE_USERS, wl.dd.num_items))
    print(f"[serving-ab] serve_msd: "
          f"{serving_scale.describe('safer2', r)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if serving_scale.ok(r) else 1


if __name__ == "__main__":
    sys.exit(main())
