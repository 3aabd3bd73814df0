"""A run with the timed path broken underneath reports correct false,
once for each fault a cell can have (one card: no exchange between
chips to leave out), and the controls at a small size."""

import json

import numpy as np
import pytest

from portbench import control, run
from portbench.tests import tiny


def _state_unchanged(monkeypatch):
    from safer2_recommender_tpu_torch.models import base
    monkeypatch.setattr(base.Recommender, "train_epochs",
                        lambda self, dd, n: None)


def _half_batch(monkeypatch):
    """Each epoch leaves half of the users' rows where they were."""
    from safer2_recommender_tpu_torch.models import base
    orig = base.Recommender.train_epochs

    def half(self, dd, n):
        for _ in range(n):
            before = self.state.user_emb
            orig(self, dd, 1)
            u = self.state.user_emb.clone()
            u[1::2] = before[1::2]
            self.state = self.state.replace(user_emb=u)
    monkeypatch.setattr(base.Recommender, "train_epochs", half)


@pytest.mark.parametrize("workload,fault", [
    ("safer2-d512.train-msd", _state_unchanged),
    ("safer2-d512.train-msd", _half_batch),
    ("safer2pp-d512-b64.train-msd", _state_unchanged),
    ("safer2pp-d512-b64.train-msd", _half_batch),
])
def test_fault_reads_incorrect(monkeypatch, workload, fault):
    fault(monkeypatch)
    rc, last, err = tiny.run(run, workload)
    assert rc == 0, err
    assert last["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in last["checks"].values())


def _control(workload, device, adjust):
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = control.main(["--workload", workload, "--seeds",
                           str(tiny.SEED)], device=device, adjust=adjust)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CONTROLS = ("program_bf16", "tf32", "half_batch")


@pytest.mark.parametrize("workload", ["safer2-d512.train-msd",
                                      "safer2pp-d512-b64.train-msd"])
def test_training_controls_tiny(workload):
    """On the CPU the low-precision reference is float32 alone (there is
    no TF32 here). The program's bf16 path and the planted half batch
    read correct false through the run's own judge."""
    import torch
    got = _control(workload, torch.device("cpu"), tiny.adjust)
    leaves = set(json.load(open(f"{run.HERE}/limits/{workload}.json"))
                 ["limits"])
    for name in CONTROLS:
        assert set(got[name]["checks"]) == leaves
        assert all(np.isfinite(c["value"])
                   for c in got[name]["checks"].values()
                   if c["value"] is not None)
    assert got["half_batch"]["checks"]["user_emb"]["value"] > 0.1
    assert got["half_batch"]["correct"] is False
    assert got["program_bf16"]["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["safer2-d512.train-msd",
                                      "safer2pp-d512-b64.train-msd"])
def test_control_fails_a_limit_on_the_card(card, workload):
    """At the test size on the card every control, the TF32 reference
    and the program's bf16 path among them, reads correct false."""
    got = _control(workload, card, tiny.adjust)
    for name in CONTROLS:
        assert got[name]["correct"] is False, (name, got[name])
