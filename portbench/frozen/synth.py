"""The MSD-shape draw the cells run on.

Origin (copied at commit fcae2312b1ea72c586087e9a4a161dd4d15691d9): the
law of ``safer2_recommender_tpu_torch/data/synth.py::powerlaw_dataset``
(log-normal history lengths with sigma 0.9, user-major repeated user
ids, items zipf over ``1 / rank ** zipf_exp``; ``zipf_pop`` is its
popularity vector). The draw below gives that law the configuration's
floor, cap and mean, and draws the items in bulk on the card. The
benchmark keeps its own copy so that a change to the program cannot
change what the benchmark feeds it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def zipf_pop(num_items: int, zipf_exp: float) -> np.ndarray:
    pop = 1.0 / (np.arange(1, num_items + 1) ** zipf_exp)
    return pop / pop.sum()


def _phi(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def clipped_mean(loc: float, sigma: float, lo: int, hi: int) -> float:
    """E[clip(floor(X), lo, hi)] for X ~ lognormal(loc, sigma)."""
    cdf = lambda k: _phi((math.log(k) - loc) / sigma)
    mean = lo * cdf(lo + 1)
    for k in range(lo + 1, hi):
        mean += k * (cdf(k + 1) - cdf(k))
    return mean + hi * (1.0 - cdf(hi))


def loc_for_mean(mean: float, sigma: float, lo: int, hi: int) -> float:
    """The log-location whose clipped, floored log-normal has ``mean``
    (bisection; deterministic)."""
    a, b = math.log(max(lo, 1)) - 5 * sigma, math.log(hi)
    for _ in range(60):
        m = 0.5 * (a + b)
        if clipped_mean(m, sigma, lo, hi) < mean:
            a = m
        else:
            b = m
    return 0.5 * (a + b)


def history_lengths(rng: np.random.Generator, n: int, ds: dict,
                    loc: float) -> np.ndarray:
    """``n`` history lengths of the configuration's dataset ``ds``."""
    return np.clip(rng.lognormal(loc, ds["lognormal_sigma"], n)
                   .astype(np.int64), ds["min_hist"], ds["max_hist"])


def msd_loc(ds: dict) -> float:
    return loc_for_mean(ds["interactions"] / ds["users"],
                        ds["lognormal_sigma"], ds["min_hist"], ds["max_hist"])


def training_set(ds: dict, seed: int, device="cpu"
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The training part of the dataset ``ds`` (a configuration's
    ``dataset``): every user's history length is drawn on the host, the
    last ``heldout_users`` are held out (validation and test, as the
    reference's ``scripts/generate_data.py`` splits MSD), and the items of
    the first ``users - heldout_users`` are drawn zipf on ``device`` (a
    torch generator seeded from ``seed``: one inverse-CDF lookup of
    uniform draws, as ``rng.choice(p=...)`` makes them, but in bulk on
    the card). Returns (user_ids, item_ids, all lengths) as host arrays,
    user-major, user ids 0..n_train-1."""
    rng = np.random.default_rng(seed)
    hist = history_lengths(rng, ds["users"], ds, msd_loc(ds))
    n_train = ds["users"] - ds["heldout_users"]
    train = hist[:n_train]
    users = np.repeat(np.arange(n_train, dtype=np.int32), train)
    items = zipf_items(int(train.sum()), ds["items"], ds["zipf_exp"],
                       seed, device)
    return users, items, hist


def zipf_items(n: int, num_items: int, zipf_exp: float, seed: int,
               device="cpu") -> np.ndarray:
    """``n`` item ids drawn zipf(``zipf_exp``) over ``num_items`` from a
    torch generator on ``device`` seeded with ``seed``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    cdf = torch.from_numpy(np.cumsum(zipf_pop(num_items, zipf_exp))).to(
        device)
    draw = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    items = torch.searchsorted(cdf, draw * cdf[-1], right=True)
    return items.clamp_(max=num_items - 1).to(torch.int32).cpu().numpy()
