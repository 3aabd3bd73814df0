"""Synthetic power-law implicit-feedback workloads (a copy of
``safer2_recommender_tpu/data/synth.py``; importing that module would
import the JAX package).

MSD, the reference's largest benchmark config (dim 512, reference
README.md "MSD" section), cannot be downloaded without network access,
so scale runs use a synthetic workload of its shape: log-normal user
history sizes and zipf-ish item popularity. The same seed gives the
same arrays as the JAX package's copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def powerlaw_dataset(num_users: int, num_items: int, mean_hist: int = 40,
                     seed: int = 0, zipf_exp: float = 0.8,
                     max_hist: int = 3000
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(user_ids, item_ids) COO arrays, user-major order."""
    rng = np.random.default_rng(seed)
    hist = np.clip(rng.lognormal(np.log(mean_hist * 0.6), 0.9,
                                 num_users).astype(np.int64), 5, max_hist)
    total = int(hist.sum())
    pop = 1.0 / (np.arange(1, num_items + 1) ** zipf_exp)
    pop /= pop.sum()
    users = np.repeat(np.arange(num_users, dtype=np.int32),
                      hist).astype(np.int32)
    items = rng.choice(num_items, size=total, p=pop).astype(np.int32)
    return users, items


def write_csv(path: str, users: np.ndarray, items: np.ndarray) -> None:
    """uid,sid CSV with header, the reference's ingest format
    (reference dataset.h:71-99 discards the header line)."""
    arr = np.stack([users, items], axis=1)
    np.savetxt(path, arr, fmt="%d", delimiter=",", header="uid,sid",
               comments="")
