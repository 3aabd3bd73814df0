"""The reader of ``sweep.table_rotations.train``: a traced run of each
cell counts one rotation of the frozen table a sweep, two an epoch; a
program that marks its epochs but rotates no table reads 0, and one
that marks no epoch gives nothing to read."""

import json
import os

import pytest

from portbench import run
from portbench.tests import tiny

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
METRIC = "sweep.table_rotations.train"


@pytest.mark.parametrize("workload", next(
    m["workloads"] for m in BENCH["per_layer"] if m["name"] == METRIC))
def test_traced_run_reads_two_rotations_an_epoch(workload):
    rc, last, err = tiny.run(run, workload, trace=1)
    assert rc == 0, err
    assert last["correct"] is True, err
    assert last["metrics"][METRIC]["value"] == 2


def test_reader_counts_the_spans_of_the_traced_epochs():
    read = run.load_module("metrics", METRIC).read
    ops = [("epoch", 0, 1), ("sweep.rotate_table", 0, 1),
           ("sweep.rotate_table", 0, 1), ("epoch", 1, 2),
           ("sweep.rotate_table", 1, 2), ("sweep.rotate_table", 1, 2)]
    assert read({"units": 2, "host_ops": ops}, None) == 2.0
    # the parent's epochs: marked, every slab rotated on its own
    slabs = [("epoch", 0, 1), ("sweep.woodbury", 0, 1), ("epoch", 1, 2)]
    assert read({"units": 2, "host_ops": slabs}, None) == 0.0
    assert read({"units": 2, "host_ops": [("aten::mm", 0, 1)]}, None) is None
