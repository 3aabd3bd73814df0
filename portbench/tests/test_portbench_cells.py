"""Every cell of BENCHMARK.json runs end to end at a tiny size on the
CPU and prints its result as the last line of standard output."""

import json
import os

import pytest

from portbench import run
from portbench.tests import tiny

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def _keys_ok(last, bench_names, trace):
    assert set(last) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(last)[-1] == "checks"
    assert last["device"]["platform"] == "cpu"
    assert set(last["metrics"]) <= bench_names
    if trace:
        assert "busy_s" in last["device"] and "window_s" in last["device"]
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_tiny(workload):
    rc, last, err = tiny.run(run, workload)
    assert rc == 0, err
    assert last["correct"] is True, err
    names = {m["name"] for m in BENCH["end_to_end"]}
    _keys_ok(last, names, False)
    want = {m["name"] for m in BENCH["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(last["metrics"]) == want
    assert all(v["value"] > 0 for v in last["metrics"].values())
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


def test_traced_run_tiny():
    rc, last, err = tiny.run(run, "safer2-d512.train-msd", trace=1)
    assert rc == 0, err
    names = {m["name"] for m in BENCH["per_layer"]}
    _keys_ok(last, names, True)
    assert last["correct"] is True


def test_no_card_no_result(monkeypatch, capsys):
    """Without CUDA the command exits non-zero and prints no result."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
