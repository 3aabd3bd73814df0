"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files (and new BENCHMARK.json entries) in a copy of the benchmark are
found without editing any file that was there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import run

REPO = run.ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.load(open(pb / "configs" / "safer2-d512.json"))
    cfg["name"] = "safer2-d512-again"
    json.dump(cfg, open(pb / "configs" / "safer2-d512-again.json", "w"))
    mix = json.load(open(pb / "traffic" / "train-msd.json"))
    mix["checked_epochs"] = 2
    json.dump(mix, open(pb / "traffic" / "train-two.json", "w"))
    cell = "safer2-d512-again.train-two"
    shutil.copy(pb / "limits" / "safer2-d512.train-msd.json",
                pb / "limits" / f"{cell}.json")
    (pb / "metrics" / "train.traced_epochs.py").write_text(
        "def read(trace, cell):\n    return float(trace['units'])\n")
    # readers of the traced window's own rows: host op spans, and kernel
    # rows by launching op (none on the CPU: the reader returns nothing
    # and the run leaves the metric out)
    (pb / "metrics" / "train.host_matmul_s.py").write_text(
        "def read(trace, cell):\n"
        "    s = sum(b - a for n, a, b in trace['host_ops']\n"
        "            if n in ('aten::mm', 'aten::bmm', 'aten::baddbmm'))\n"
        "    return s if s > 0 else None\n")
    (pb / "metrics" / "train.bmm_launches.py").write_text(
        "def read(trace, cell):\n"
        "    n = sum(k.launches for k in trace['kernels']\n"
        "            if k.op in ('aten::bmm', 'aten::baddbmm'))\n"
        "    return float(n) if n else None\n")
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["configs"].append(dict(bench["configs"][0],
                                 name="safer2-d512-again",
                                 file="portbench/configs/"
                                      "safer2-d512-again.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=cell,
                                   config="safer2-d512-again",
                                   traffic="train-two"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "safer2-d512.train-msd" in m["workloads"]:
            m["workloads"].append(cell)
    for name, unit, source in (
            ("train.traced_epochs", "epochs", "program_counter"),
            ("train.host_matmul_s", "s", "program_span"),
            ("train.bmm_launches", "launches", "device_trace")):
        bench["per_layer"].append(dict(bench["per_layer"][0], name=name,
                                       unit=unit, source=source,
                                       workloads=[cell]))
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = ("import json, sys\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            f"rc, last, err = tiny.run(run, {cell!r}, trace=1)\n"
            "print(json.dumps([rc, last, err[-2000:]]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    rc, last, err = json.loads(p.stdout.strip().splitlines()[-1])
    assert rc == 0, err
    assert last["metrics"]["train.traced_epochs"]["value"] == 1.0
    assert last["metrics"]["train.host_matmul_s"]["value"] > 0
    assert "train.bmm_launches" not in last["metrics"]
    assert last["attempted"] >= 1
    after = _digests(tmp_path)
    assert {k: after[k] for k in before
            if k != "BENCHMARK.json"} == {k: v for k, v in before.items()
                                          if k != "BENCHMARK.json"}


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files a run fails and prints no result (the port is missing)."""
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    code = ("import torch\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "rc = run.main(['--workload', 'safer2-d512.train-msd', '--seed',"
            " '3', '--seconds', '1', '--trace', '0'],"
            " device=torch.device('cpu'), adjust=tiny.adjust)\n"
            "raise SystemExit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "safer2_recommender_tpu_torch" in p.stderr
