"""The readers of the program's own spans (``portbench/spans.py``): a
traced run reports the two counters and, on the CPU, which times no
span on a device, leaves the device-ms metrics out; a program without
spans gives every reader nothing to read."""

import json
import os

import pytest

from portbench import run, spans
from portbench.tests import tiny

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
DEVICE_MS = ("epoch.loss_ms.train", "epoch.xi_ms.train",
             "epoch.u_sweep_ms.train", "epoch.v_sweep_ms.train")
CONFIGS = {w["name"]: json.load(open(os.path.join(
    run.ROOT, next(c["file"] for c in BENCH["configs"]
                   if c["name"] == w["config"]))))
    for w in BENCH["workloads"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traced_run_reports_the_counters(workload):
    rc, last, err = tiny.run(run, workload, trace=1)
    assert rc == 0, err
    assert last["correct"] is True, err
    got = last["metrics"]
    # at least one Armijo test per Newton step, and an eigh a sweep
    xi_steps = CONFIGS[workload]["config"]["xi_iterations"]
    assert got["epoch.host_syncs.train"]["value"] >= xi_steps + 2
    assert got["chol_inverse.launches.train"]["value"] > 0
    assert not set(DEVICE_MS) & set(got)


class _Span:
    def __init__(self, name, epoch, device_ms):
        self.name, self.epoch, self.device_ms = name, epoch, device_ms


def test_readers_of_a_program_without_spans_return_none(monkeypatch):
    trace = {"units": 2, "host_ops": [("aten::mm", 0.0, 1.0)]}
    from safer2_recommender_tpu_torch.utils import logging
    monkeypatch.setattr(logging, "spans", lambda: [])
    for name in DEVICE_MS + ("epoch.host_syncs.train",
                             "chol_inverse.launches.train"):
        assert run.load_module("metrics", name).read(trace, None) is None
    # a tree older than the spans has no reader of them to import
    monkeypatch.delattr(logging, "spans")
    assert spans.phase_ms(trace, "epoch.loss") is None


def test_phase_ms_reads_the_last_epochs(monkeypatch):
    from safer2_recommender_tpu_torch.utils import logging
    recs = [_Span("epoch", k, 100.0) for k in range(3)]
    recs += [_Span("epoch.loss", k, 10.0 * (k + 1)) for k in range(3)]
    monkeypatch.setattr(logging, "spans", lambda: recs)
    assert spans.phase_ms({"units": 2}, "epoch.loss") == 25.0
    recs.append(_Span("epoch.loss", 2, None))
    assert spans.phase_ms({"units": 2}, "epoch.loss") is None
    trace = {"units": 2, "host_ops": [("epoch", 0, 1), ("host_sync.a", 0, 1),
                                      ("host_sync.b", 1, 2), ("epoch", 1, 2)]}
    assert spans.count(trace, "host_sync.") == 1.0
