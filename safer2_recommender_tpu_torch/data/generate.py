"""Offline dataset preparation: ML-1M / ML-20M / MSD splits + ML-1M CV
(the port's own copy of ``safer2_recommender_tpu/data/generate.py``).

Capability parity with the reference's data-prep scripts
(reference scripts/generate_data.py:92-226 and
scripts/generate_data_ml1m_cv.py): binarize explicit ratings at > 3.5,
filter rare users/items, hold out validation/test *user* populations
("strong generalization"), split each held-out user's interactions
80/20 into fold-in (tr) and ground-truth (te), and re-index to dense ids
(items by first appearance in the train split, users by the permuted
order). The same seed gives the same files as the JAX package's module.

Differences from the reference (documented, not accidental):
  * The per-user 80/20 split is vectorized (one permutation over all
    tuples instead of a Python loop with one np.random.choice per user,
    reference generate_data.py:63-89), so the RNG stream differs; the
    split law is identical (per user with >= 5 ratings, floor(0.2*n)
    tuples go to te).
  * Nothing is downloaded: ``--input`` must point at a raw file that is
    already on disk.
  * ``load_raw`` reads with numpy (the JAX package's reads with pandas,
    which the port does not need).

CLI:
  python -m safer2_recommender_tpu_torch.data.generate \
      --dataset ml-1m --input ratings.dat --output_dir out/ml-1m
  python -m safer2_recommender_tpu_torch.data.generate \
      --dataset ml-1m-cv --input ratings.dat --output_dir out/ml-1m-cv
"""

from __future__ import annotations

import argparse
import io
import os
from dataclasses import dataclass

import numpy as np

DEFAULT_SEED = 98765  # reference generate_data.py:66,118


@dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset prep parameters (reference generate_data.py:164-226)."""

    n_heldout_users: int
    min_uc: int
    min_sc: int
    binarize: bool  # keep rating > 3.5 (MovieLens); MSD uses all triplets


SPECS = {
    "ml-1m": DatasetSpec(n_heldout_users=1000, min_uc=5, min_sc=0,
                         binarize=True),
    "ml-20m": DatasetSpec(n_heldout_users=10000, min_uc=5, min_sc=0,
                          binarize=True),
    "msd": DatasetSpec(n_heldout_users=50000, min_uc=20, min_sc=200,
                       binarize=False),
}

URLS = {
    "ml-1m": "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
    "ml-20m": "http://files.grouplens.org/datasets/movielens/ml-20m.zip",
    "msd": ("http://millionsongdataset.com/sites/default/files/challenge/"
            "train_triplets.txt.zip"),
}


def load_raw(dataset: str, path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a local raw interaction file -> (user_keys, item_keys) after
    binarizing (MovieLens keeps rating > 3.5):

      ml-1m   ratings.dat, ``user::movie::rating::timestamp``, no header
      ml-20m  ratings.csv, header ``userId,movieId,rating,timestamp``
      msd     train_triplets.txt, ``user<TAB>song<TAB>count``, no header;
              its keys are strings

    MovieLens keys come back as int64, MSD keys as strings."""
    if dataset == "ml-1m":
        with open(path) as f:
            text = f.read().replace("::", ",")
        cols = np.loadtxt(io.StringIO(text), delimiter=",", ndmin=2,
                          usecols=(0, 1, 2))
        names = ("userId", "movieId", "rating")
    elif dataset == "ml-20m":
        with open(path) as f:
            names = tuple(next(f).strip().split(","))
        cols = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2,
                          usecols=tuple(range(len(names))))
    elif dataset == "msd":
        cols = np.loadtxt(path, delimiter="\t", dtype=str, ndmin=2,
                          usecols=(0, 1))
        return cols[:, 0], cols[:, 1]
    else:
        raise ValueError(dataset)
    users = cols[:, names.index("userId")].astype(np.int64)
    items = cols[:, names.index("movieId")].astype(np.int64)
    if SPECS[dataset].binarize:
        keep = cols[:, names.index("rating")] > 3.5
        users, items = users[keep], items[keep]
    return users, items


def _filter_rare(users: np.ndarray, items: np.ndarray, min_uc: int,
                 min_sc: int):
    """Drop rare items first, then rare users (reference
    generate_data.py:24-49 order: min_sc filter precedes min_uc)."""
    if min_sc > 0:
        _, inv, counts = np.unique(items, return_inverse=True,
                                   return_counts=True)
        keep = counts[inv] >= min_sc
        users, items = users[keep], items[keep]
    if min_uc > 0:
        _, inv, counts = np.unique(users, return_inverse=True,
                                   return_counts=True)
        keep = counts[inv] >= min_uc
        users, items = users[keep], items[keep]
    return users, items


def _per_user_split(users: np.ndarray, items: np.ndarray, test_prop: float,
                    rng: np.random.RandomState):
    """Vectorized per-user holdout: for each user with >= 5 tuples, a
    uniformly random floor(test_prop * n) of them go to 'te'."""
    order = rng.permutation(users.size)
    u_perm, i_perm = users[order], items[order]
    sort = np.argsort(u_perm, kind="stable")
    u_sorted, i_sorted = u_perm[sort], i_perm[sort]
    _, starts, counts = np.unique(u_sorted, return_index=True,
                                  return_counts=True)
    within = np.arange(u_sorted.size) - np.repeat(starts, counts)
    n_te = np.where(counts >= 5,
                    (test_prop * counts).astype(np.int64), 0)
    is_te = within < np.repeat(n_te, counts)
    return ((u_sorted[~is_te], i_sorted[~is_te]),
            (u_sorted[is_te], i_sorted[is_te]))


def _write_csv(path: str, uid: np.ndarray, sid: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("uid,sid\n")
        np.savetxt(f, np.column_stack([uid, sid]), fmt="%d", delimiter=",")


def generate_splits(users: np.ndarray, items: np.ndarray, output_dir: str,
                    spec: DatasetSpec, seed: int = DEFAULT_SEED) -> dict:
    """Produce train / validation_{tr,te} / test_{tr,te} CSVs.

    Matches the reference protocol (generate_data.py:92-161): permute
    distinct users with the given seed; the last 2*n_heldout are the
    validation and test populations; items unseen in train are dropped
    from the held-out sets; ids are densified (items by first appearance
    in train, users by permuted position).
    """
    users, items = _filter_rare(users, items, spec.min_uc, spec.min_sc)
    rng = np.random.RandomState(seed)
    uniq_users = np.unique(users)
    perm = uniq_users[rng.permutation(uniq_users.size)]
    n = perm.size
    h = spec.n_heldout_users
    if n <= 2 * h:
        # negative slice starts would silently wrap and corrupt the
        # heldout populations (empty validation, oversized test)
        raise ValueError(
            f"only {n} distinct users after filtering; need more than "
            f"2 * n_heldout_users = {2 * h} to carve the heldout splits")
    vd_users = set(perm[n - 2 * h: n - h].tolist())
    te_users = set(perm[n - h:].tolist())

    # vectorized rank lookup: rank[perm[i]] = i (MSD is ~48M tuples;
    # per-element dict lookups cost minutes of pure Python)
    order = np.argsort(perm)
    uid = order[np.searchsorted(perm[order], users)]
    in_vd = np.isin(users, list(vd_users))
    in_te = np.isin(users, list(te_users))
    in_tr = ~(in_vd | in_te)

    # item ids: dense, ordered by first appearance in the train split
    tr_items = items[in_tr]
    first_idx = np.unique(tr_items, return_index=True)[1]
    train_item_keys = tr_items[np.sort(first_idx)]
    known = np.isin(items, train_item_keys)
    sid = np.full(items.size, -1, np.int64)
    iorder = np.argsort(train_item_keys)
    sid[known] = iorder[np.searchsorted(train_item_keys[iorder],
                                        items[known])]

    out = {}
    _write_csv(os.path.join(output_dir, "train.csv"),
               uid[in_tr], sid[in_tr])
    out["train"] = int(in_tr.sum())
    for name, mask in (("validation", in_vd), ("test", in_te)):
        keep = mask & known
        (utr, itr), (ute, ite) = _per_user_split(
            uid[keep], sid[keep], test_prop=0.2, rng=rng)
        _write_csv(os.path.join(output_dir, f"{name}_tr.csv"), utr, itr)
        _write_csv(os.path.join(output_dir, f"{name}_te.csv"), ute, ite)
        out[f"{name}_tr"] = utr.size
        out[f"{name}_te"] = ute.size
    with open(os.path.join(output_dir, "unique_sid.txt"), "w") as f:
        f.writelines(f"{s}\n" for s in train_item_keys.tolist())
    return out


def cv_seeds(meta_seed: int = DEFAULT_SEED, n: int = 50) -> np.ndarray:
    """The reference's 50 CV seeds (generate_data_ml1m_cv.py:187-189)."""
    return np.random.RandomState(meta_seed).randint(0, 100000000, size=n)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   choices=["ml-1m", "ml-20m", "msd", "ml-1m-cv"])
    p.add_argument("--input", required=True,
                   help="raw ratings file (ratings.dat / ratings.csv / "
                        "train_triplets.txt); downloads are not performed "
                        f"here — fetch from {URLS} yourself")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = p.parse_args(argv)

    base = args.dataset.removesuffix("-cv")
    users, items = load_raw(base, args.input)
    if args.dataset == "ml-1m-cv":
        for seed in cv_seeds(args.seed):
            stats = generate_splits(
                users, items, os.path.join(args.output_dir, str(seed)),
                SPECS[base], seed=int(seed))
            print(seed, stats)
    else:
        stats = generate_splits(users, items, args.output_dir, SPECS[base],
                                seed=args.seed)
        print(stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
