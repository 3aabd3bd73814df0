"""The port never imports JAX: importing every module of
safer2_recommender_tpu_torch in a fresh interpreter leaves ``jax`` and
``safer2_recommender_tpu`` out of ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import safer2_recommender_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "safer2_recommender_tpu"
             or m.startswith("safer2_recommender_tpu."))
print(len(names), bad, ",".join(names))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    count, bad, names = res.stdout.strip().split(" ", 2)
    assert int(count) >= 20        # every module was reached
    assert bad == "[]", bad
    for mod in ("ops.woodbury", "ops.bdot", "data.synth", "probes.bdot",
                "probes.epoch_profile"):
        assert f"safer2_recommender_tpu_torch.{mod}" in names.split(","), mod


def test_chip_smoke_imports_no_jax():
    # chip_smoke.py loads the port only inside main(); importing it and
    # the port's CLI must not pull JAX in either
    probe = ("import sys, chip_smoke; "
             "import safer2_recommender_tpu_torch.cli; "
             "print([m for m in sys.modules if m.split('.')[0] == 'jax'])")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
