"""The port's measuring entry points against the JAX package's own:
``safer2_recommender_tpu_torch/bench.py`` against the repository's
``bench.py``, and ``dryrun.entry`` against ``__graft_entry__.entry``,
on the CPU."""

import ast
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import bench as jax_bench
import safer2_recommender_tpu as jx
from safer2_recommender_tpu.data import synth as jsynth
from safer2_recommender_tpu_torch import (Config, Dataset, DeviceData, dryrun,
                                          get_model, interop)
from safer2_recommender_tpu_torch import bench
from safer2_recommender_tpu_torch.config import JAX_EIG_REFRESH_TOL
from safer2_recommender_tpu_torch.data import synth as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, several worker processes side by side: one intra-op
    thread each keeps them from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bench_py_configs():
    """The keyword arguments of the two ``Config(...)`` calls of
    ``bench.py`` (:114-117, the north star, whose ``dim`` is a variable;
    :222-224, ML-1M), read from its source."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "Config"]
    assert [c.lineno for c in calls] == [114, 222]
    return [{k.arg: (None if isinstance(k.value, ast.Name)
                     else ast.literal_eval(k.value)) for k in c.keywords}
            for c in calls]


@pytest.mark.parametrize("batch,seed", [(48, 148), (900, 1000), (64, 403)])
def test_serve_batch_draws_bench_pys_users(batch, seed):
    ds = Dataset(*tsynth.powerlaw_dataset(300, 2_000, seed=0))
    jds = jx.Dataset(ds.user_ids, ds.item_ids)
    got = bench._serve_batch(ds, batch, seed)
    want = jax_bench._serve_batch(jds, batch, seed)
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)


def test_configs_and_workload_are_bench_pys():
    ns, ml = _bench_py_configs()
    assert ns.pop("dim") is None
    assert bench.northstar_config() == Config(dim=bench.NS_DIM, **ns)
    assert bench.ml1m_config() == Config(**ml)
    # the JAX Config's defaults fill the fields bench.py leaves out, all
    # but eig_refresh_tol: the port's default is 0 (a full eigh every
    # sweep, exact and faster on the H100), the JAX package's 0.08 (its
    # TPU trade), a deliberate difference (config.py)
    for port, jax_cfg in ((bench.northstar_config(),
                           jx.Config(dim=bench.NS_DIM, **ns)),
                          (bench.ml1m_config(), jx.Config(**ml))):
        got, want = dataclasses.asdict(port), dataclasses.asdict(jax_cfg)
        assert got.pop("eig_refresh_tol") == 0.0
        assert want.pop("eig_refresh_tol") == JAX_EIG_REFRESH_TOL == 8e-2
        assert got == want
    assert (bench.NS_USERS, bench.NS_ITEMS, bench.NS_DIM, bench.NS_SEED) == (
        jax_bench.NS_USERS, jax_bench.NS_ITEMS, jax_bench.NS_DIM,
        jax_bench.NS_SEED)
    assert bench.ML1M_DIR == jax_bench.ML1M_DIR
    for got, want in zip(tsynth.powerlaw_dataset(2_000, 1_500, seed=0),
                         jsynth.powerlaw_dataset(2_000, 1_500, seed=0)):
        np.testing.assert_array_equal(got, want)


def test_read_baseline_reads_only_the_cpp_reference():
    for key in bench.BASELINE_KEYS:
        assert bench.read_baseline(key) == jax_bench.read_baseline(key) > 0
    with pytest.raises(ValueError, match="only"):
        bench.read_baseline("recorded_safer2_dim512_epoch_ms")


def test_run_on_the_cpu_gives_bench_pys_record():
    record, detail = bench.run("cpu", users=2_000, items=1_500, dim=16,
                               epochs=2, ml1m_epochs=3)
    # the keys of bench.py's line (its last recorded run, BENCH_r05.json)
    # less its TPU regression gate and backend, plus the card's name
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        want = set(json.load(f)["parsed"]) - {"regressions", "backend"}
    assert set(record) == want | {"device"}
    assert record["device"] == "cpu" and record["dim"] == 16
    numbers = {k: v for k, v in record.items()
               if k not in ("metric", "unit", "device")}
    assert all(isinstance(v, (int, float)) and math.isfinite(v)
               for v in numbers.values()), numbers
    assert set(detail["epoch_ms"]) == set(bench.MODELS)
    assert all(len(ms) == 2 for ms in detail["epoch_ms"].values())
    assert len(detail["ml1m_dim32_epoch_ms"]) == 3
    progs = detail["serving_programs"]
    assert progs["after_varying"] == progs["after_warmup"] > 0
    assert record["serving_compiled_programs"] == progs["at_end"]
    assert record["ml1m_safer2_dim32_ndcg20_10ep"] >= 0.2
    line = bench.describe(detail)
    assert "Server programs: " in line and "cvar_mf" in line


def test_ml1m_ndcg_matches_jax_from_carried_tables():
    # bench.py's ML-1M quality number (dim 32, 10 epochs) from the JAX
    # package's initial tables on both sides
    cfg = bench.ml1m_config()
    train_csv = os.path.join(bench.ML1M_DIR, "train.csv")
    jtrain = jx.Dataset.from_csv(train_csv)
    jdd = jx.DeviceData.build(jtrain, dim=cfg.dim)
    jm = jx.get_model("safer2", jx.Config(**dataclasses.asdict(cfg)),
                      jtrain.num_users, jtrain.num_items)
    jm.initialize(jdd)
    train = Dataset.from_csv(train_csv)
    dd = DeviceData.build(train, device="cpu", dim=cfg.dim)
    tm = get_model("safer2", cfg, train.num_users, train.num_items,
                   device="cpu")
    interop.state_from_jax(jm.export_state(jdd), tm, dd)
    got = bench.ml1m_ndcg20(tm, dd, bench.ml1m_fold(train, "cpu"))

    jm.train_epochs(jdd, bench.NDCG_EPOCHS)
    jfold = jx.FoldInData.build(
        jx.Dataset.from_csv(os.path.join(bench.ML1M_DIR,
                                         "validation_tr.csv")),
        jx.Dataset.from_csv(os.path.join(bench.ML1M_DIR,
                                         "validation_te.csv")),
        num_items=jtrain.num_items)
    want = float(np.asarray(jm.evaluate_dataset(jfold, k_list=(20,))
                            .ndcg).mean(0)[0])
    assert got >= 0.2
    assert abs(got - want) <= 2e-3, (got, want)


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_entry_matches_the_jax_entry():
    fn, args = __graft_entry__.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    port_fn, port_args = dryrun.entry("cpu")
    for a, b in zip(port_args, args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = [x.numpy() for x in port_fn(*port_args)]
    assert [g.shape for g in got] == [w.shape for w in want] == [(256, 5)] * 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_bench_traffic_lands_on_the_warmed_programs():
    # bench.py's Server traffic at its own shapes (a dim-512 SAFER2 on
    # the 50k x 40k catalog: rows of <= 256 items are a sub-batch of
    # their own): after the warm-up batches the 16 varying batches need
    # no new program; the requests of 64 users add the (64, 128) rung.
    # Keyed by a request's tuple of rung pairs, as the Server was before
    # each sub-batch ran its own program, six varying batches would have
    # needed two programs the warm-up had not built (CUDA graphs
    # captured under the traffic, which bench.py's assert forbids).
    from safer2_recommender_tpu_torch import Server

    model = get_model("safer2", bench.northstar_config(), 1, bench.NS_ITEMS,
                      device="cpu")
    assert model._fold_in_split() == 256
    srv = Server(model, k=bench.SERVE_K, batch_sizes=(64, 1024, 4096),
                 widths=(128, 512))
    catalog = Dataset(np.zeros(1, np.int32),
                      np.array([bench.NS_ITEMS - 1], np.int32))

    def keys(batch, seed):
        b = bench._serve_batch(catalog, batch, seed)
        return [shapes for _, shapes, _ in srv._pack(b.user_ids,
                                                     b.item_ids)]

    warm = [keys(b, 100 + b) for b in bench.SERVE_WARMUP]
    sizes = np.random.default_rng(11).integers(256, 4096,
                                               bench.SERVE_VARYING)
    varying = [keys(int(b), 200 + i) for i, b in enumerate(sizes)]
    small = [keys(64, 400 + i) for i in range(bench.SERVE_P50_REQUESTS)]
    programs = {k for ks in warm for k in ks}
    assert len(programs) == 4
    assert {k for ks in varying for k in ks} <= programs
    assert {k for ks in small for k in ks} - programs == {((64, 128),)}
    requests = {tuple(ks) for ks in warm}
    new = [tuple(ks) for ks in varying if tuple(ks) not in requests]
    assert (len(new), len(set(new))) == (6, 2)
