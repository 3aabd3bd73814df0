"""The port's data preparation (``safer2_recommender_tpu_torch.data.
generate``) against the JAX package's module, and the port's tuning
tool (``safer2_recommender_tpu_torch.tune``), on the CPU.

The raw files are synthetic tuples written to ``tmp_path`` in each raw
format the modules read; these are the cases of tests/test_generate.py
that need no download. The JAX module reads them with pandas, the
port's with numpy: both must write the same files, byte for byte."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from safer2_recommender_tpu.data import generate as jgen
from safer2_recommender_tpu_torch.data import generate as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML1M_DIR = os.environ.get(
    "FRECSYS_ML1M_DIR",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "ml-1m"))
OUT_FILES = ("train.csv", "validation_tr.csv", "validation_te.csv",
             "test_tr.csv", "test_te.csv", "unique_sid.txt")


@pytest.fixture()
def raw():
    """tests/test_generate.py::raw."""
    rng = np.random.default_rng(7)
    n = 30000
    users = rng.integers(0, 800, n)
    items = rng.zipf(1.5, n) % 400
    return users, items


def _tuples(seed, n, n_users, n_items=700):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, n_users, n), (rng.zipf(1.4, n) % n_items) + 1,
            rng.integers(1, 6, n))


def _write_raw(tmp_path, dataset, n=40_000, n_users=1500):
    """Synthetic raw interactions in ``dataset``'s file format."""
    users, items, ratings = _tuples(3, n, n_users)
    path = tmp_path / f"raw_{dataset}"
    with open(path, "w") as f:
        if dataset == "ml-1m":
            for u, i, r in zip(users, items, ratings):
                f.write(f"{u}::{i}::{r}::978300760\n")
        elif dataset == "ml-20m":
            f.write("userId,movieId,rating,timestamp\n")
            for u, i, r in zip(users, items, ratings):
                f.write(f"{u},{i},{r - 0.5 * (u % 2)},1112486027\n")
        else:
            # MSD keys are hex strings; play counts are not filtered on
            for u, i, r in zip(users, items, ratings):
                f.write(f"{u * 7919:x}a{u}\tSO{i:06x}\t{r}\n")
    return str(path)


@pytest.mark.parametrize("dataset", ["ml-1m", "ml-20m", "msd"])
def test_load_raw_matches_jax(tmp_path, dataset):
    path = _write_raw(tmp_path, dataset)
    got = tgen.load_raw(dataset, path)
    want = jgen.load_raw(dataset, path)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert [str(x) for x in g[:200]] == [str(x) for x in w[:200]]
        np.testing.assert_array_equal(g.astype(str), w.astype(str))
    if dataset != "msd":
        assert got[0].dtype == np.int64
        # binarized at > 3.5
        assert 0 < got[0].size < _tuples(3, 40_000, 1500)[0].size
    with pytest.raises(ValueError):
        tgen.load_raw("nope", path)


@pytest.mark.parametrize("dataset", ["ml-1m", "ml-20m", "msd"])
def test_generate_splits_writes_the_jax_files(tmp_path, dataset):
    path = _write_raw(tmp_path, dataset)
    spec = tgen.DatasetSpec(n_heldout_users=200, min_uc=5,
                            min_sc=3 if dataset == "msd" else 0,
                            binarize=tgen.SPECS[dataset].binarize)
    jspec = jgen.DatasetSpec(**spec.__dict__)
    got = tgen.generate_splits(*tgen.load_raw(dataset, path),
                               str(tmp_path / "port"), spec)
    want = jgen.generate_splits(*jgen.load_raw(dataset, path),
                                str(tmp_path / "jax"), jspec)
    assert got == want
    for name in OUT_FILES:
        with open(tmp_path / "port" / name, "rb") as g, \
                open(tmp_path / "jax" / name, "rb") as w:
            assert g.read() == w.read(), name


def test_generate_splits(tmp_path, raw):
    # tests/test_generate.py::test_generate_splits on the port, read
    # back with numpy
    users, items = raw
    spec = tgen.DatasetSpec(n_heldout_users=50, min_uc=5, min_sc=3,
                            binarize=False)
    stats = tgen.generate_splits(users, items, str(tmp_path), spec)
    for f in OUT_FILES:
        assert os.path.exists(tmp_path / f)

    def load(name):
        return np.loadtxt(tmp_path / name, delimiter=",", skiprows=1,
                          dtype=np.int64, ndmin=2)

    train, vtr, vte, ttr = (load(f) for f in OUT_FILES[:4])
    assert len(train) == stats["train"]
    # user populations are disjoint
    assert not set(train[:, 0]) & set(vtr[:, 0])
    assert not set(train[:, 0]) & set(ttr[:, 0])
    assert not set(vtr[:, 0]) & set(ttr[:, 0])
    # te users subset of tr users; items only from the train catalog
    assert set(vte[:, 0]) <= set(vtr[:, 0])
    n_items = train[:, 1].max() + 1
    for a in (vtr, vte, ttr):
        assert a[:, 1].max() < n_items
    assert set(np.unique(train[:, 1])) == set(range(n_items))
    # the te share of each held-out user with >= 5 tuples is floor(20%)
    both = np.concatenate([vtr, vte])
    uid, per_user = np.unique(both[:, 0], return_counts=True)
    te_uid, te_count = np.unique(vte[:, 0], return_counts=True)
    te = dict(zip(te_uid.tolist(), te_count.tolist()))
    for u, n in zip(uid.tolist(), per_user.tolist()):
        if n >= 5:
            assert te.get(u, 0) == int(0.2 * n)


def test_min_count_filters_match_jax(raw):
    users, items = raw
    u2, i2 = tgen._filter_rare(users, items, min_uc=10, min_sc=8)
    _, uc = np.unique(u2, return_counts=True)
    assert uc.min() >= 10
    ju, ji = jgen._filter_rare(users, items, min_uc=10, min_sc=8)
    np.testing.assert_array_equal(u2, ju)
    np.testing.assert_array_equal(i2, ji)


def test_cv_seeds_match_jax():
    a, b = tgen.cv_seeds(), tgen.cv_seeds()
    assert np.array_equal(a, b)
    assert len(a) == 50
    np.testing.assert_array_equal(a, jgen.cv_seeds())
    np.testing.assert_array_equal(tgen.cv_seeds(5, n=3), jgen.cv_seeds(5, 3))


def test_generate_splits_rejects_too_few_users(tmp_path, raw):
    users, items = raw
    spec = tgen.DatasetSpec(n_heldout_users=10**6, min_uc=1, min_sc=1,
                            binarize=False)
    with pytest.raises(ValueError, match="heldout"):
        tgen.generate_splits(users, items, str(tmp_path), spec)


def test_generate_cli_runs_from_the_port(tmp_path):
    # python -m safer2_recommender_tpu_torch.data.generate at the ML-1M
    # spec (1,000 held-out users of each split)
    path = _write_raw(tmp_path, "ml-1m", n=100_000, n_users=2600)
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "safer2_recommender_tpu_torch.data.generate",
         "--dataset", "ml-1m", "--input", path, "--output_dir", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    stats = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    assert stats["train"] > 0
    for name in OUT_FILES:
        assert (out / name).exists()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_pandas():
    # the card's machine has no pandas: no module of the port imports it
    root = os.path.join(REPO, "safer2_recommender_tpu_torch")
    found = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found += [(path, m) for m in _imports(path)
                          if m.split(".")[0] == "pandas"]
    assert found == []
    # the scan sees an import inside a function (the JAX module's)
    assert "pandas" in set(_imports(jgen.__file__))
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, safer2_recommender_tpu_torch.data.generate, "
         "safer2_recommender_tpu_torch.tune; "
         "print('pandas' in sys.modules)"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "False"


def test_tune_two_trials_on_ml1m(tmp_path):
    out = tmp_path / "best.json"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "safer2_recommender_tpu_torch.tune",
         "--model_name", "safer2",
         "--train_data", os.path.join(ML1M_DIR, "train.csv"),
         "--test_train_data", os.path.join(ML1M_DIR, "validation_tr.csv"),
         "--test_test_data", os.path.join(ML1M_DIR, "validation_te.csv"),
         "--trials", "2", "--epoch", "2", "--dim", "8", "--device", "cpu",
         "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(x) for x in res.stdout.strip().splitlines()]
    assert [x["trial"] for x in lines[:2]] == [0, 1]
    assert lines[-1]["metric"] == "mean_ndcg@20"
    with open(out) as f:
        best = json.load(f)
    assert len(best["trials"]) == 2
    assert best["best"]["score"] == max(t["score"] for t in best["trials"])
    assert set(best["best"]["hyperparams"]) == {"uobs_weight", "l2_reg",
                                                "bandwidth"}
    assert 0.0 < best["best"]["score"] <= 1.0
