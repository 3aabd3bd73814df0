"""CVaR-MF's cell (``drivers/train_hard.py``): the port against the plain
reference (``reference/cvar_mf.py``) where the losses are well spread,
the exact quantile's index pinned, the near-tie rule's check and its
faults, the controls, and the readers of the new spans."""

import json

import numpy as np
import pytest
import torch

from portbench import control_hard, run
from portbench.drivers import train, train_hard
from portbench.frozen import synth
from portbench.reference.common import Prec
from portbench.tests import tiny

WORKLOAD = "cvar_mf-d512.train-msd-hard"
LEAVES = ("user_emb", "item_emb", "dual_weight", "xi", "user_loss")


def _spread(cell) -> None:
    """The tiny size with tables ten times wider: the losses then lie far
    apart beside float32's rounding, so no user is near a tie."""
    tiny.adjust(cell)
    cell.config["config"]["stdev"] = 1.0


def _cell(adjust=_spread, seed=tiny.SEED):
    bench = json.load(open(f"{run.ROOT}/BENCHMARK.json"))
    cell = run.cell_for(bench, WORKLOAD, seed, 0.0, False,
                        torch.device("cpu"))
    adjust(cell)
    return cell


def _xi_index_errors(prog: list, alpha: float) -> list:
    """Per checked epoch after the first, whether the program's xi is
    not exactly its own floor(n alpha)-th largest loss."""
    bad = []
    for snap in prog[2:]:
        loss = np.sort(snap["user_loss"])[::-1]
        q = min(int(loss.size * alpha), loss.size - 1)
        bad.append(float(snap["xi"][0]) != float(loss[q]))
    return bad


@pytest.fixture(scope="module")
def spread():
    """The program's checked epochs at the spread size, and the plain
    reference's, with the near-tie rule's statistics."""
    cell = _cell()
    data, order, dd, model, prog = train.setup(cell)
    del model, dd
    ref, stats = train_hard.follow(cell, data, order, prog,
                                   Prec(torch.float64))
    return cell, prog, ref, stats


def test_port_follows_the_reference_where_losses_are_spread(spread):
    """Every leaf within float32's rounding of the float64 reference
    (||program - reference|| over the reference's change), and the same
    z for every user; the band holds no user but, after the first epoch,
    the one whose loss is xi."""
    cell, prog, ref, stats = spread
    assert len(prog) == len(ref) == cell.traffic["checked_epochs"] + 1
    worst = train.compare(prog, ref)
    assert worst["dual_weight"] == 0.0
    for leaf in ("user_emb", "item_emb", "xi", "user_loss"):
        assert worst[leaf] < 1e-5, (leaf, worst)
    assert [s[0] for s in stats] == [0] + [1] * (len(stats) - 1)
    assert [s[1] for s in stats] == [0] * len(stats)
    # each epoch's loss within float32 rounding of the reference's
    assert max(s[2] for s in stats) < 1e-6
    # after the first epoch the indicator splits the users
    z = ref[-1]["dual_weight"].numpy()
    assert 0 < z.sum() < z.size


def test_xi_is_exactly_the_floor_n_alpha_th_largest(spread):
    """The program's xi is its own floor(n alpha)-th largest loss, bit
    for bit, and belongs to the user whose loss is the reference's xi:
    one index off would put it on a neighbour, which the near-tie band
    cannot tell at the cell's size."""
    cell, prog, ref, _ = spread
    alpha = cell.config["config"]["alpha"]
    assert _xi_index_errors(prog, alpha) == [False] * (len(prog) - 2)
    for snap, st in zip(prog[2:], ref[2:]):
        loss = st["user_loss"]
        q = int(loss.numel() * alpha)
        assert float(st["xi"]) == float(torch.sort(
            loss, descending=True).values[q])
        who_ref = int(torch.argmin((loss - st["xi"]).abs()))
        who_prog = int(np.argmin(np.abs(snap["user_loss"]
                                        - snap["xi"][0])))
        assert who_prog == who_ref


def _quantile_at(monkeypatch, index):
    """The port's exact quantile taken at ``index(n, alpha)`` instead."""
    from safer2_recommender_tpu_torch.ops import quantile

    def at(losses, alpha):
        n = losses.shape[0]
        return torch.sort(losses, descending=True).values[index(n, alpha)]
    monkeypatch.setattr(quantile, "exact_quantile", at)


def test_an_index_one_off_is_caught_by_the_pin(monkeypatch):
    _quantile_at(monkeypatch, lambda n, a: int(n * a) + 1)
    cell = _cell()
    _, _, dd, model, prog = train.setup(cell)
    assert all(_xi_index_errors(prog, cell.config["config"]["alpha"]))


def test_tiny_cell_reads_correct():
    rc, last, err = tiny.run(run, WORKLOAD)
    assert rc == 0, err
    assert last["correct"] is True, err
    assert set(last["checks"]) == set(LEAVES) | {"z_outside_band"}
    assert last["checks"]["z_outside_band"]["value"] == 0.0
    assert last["checks"]["dual_weight"]["value"] == 0.0
    assert "users in the band" in err


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


def _xi_at_half_index(monkeypatch):
    _quantile_at(monkeypatch, lambda n, a: int(n * a / 2))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _xi_at_half_index])
def test_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    rc, last, err = tiny.run(run, WORKLOAD)
    assert rc == 0, err
    assert last["correct"] is False
    if fault is _xi_at_half_index:
        # the users between the two quantiles flip, far outside the band
        assert last["checks"]["z_outside_band"]["value"] > 0
        assert last["checks"]["dual_weight"]["value"] > \
            last["checks"]["dual_weight"]["limit"]


def test_band_takes_the_programs_z_and_counts_the_rest():
    """A program whose z differs from the follower's on one user outside
    the band and on every user inside it reads one z outside the band,
    and the follower takes the program's z in the band."""
    cell = _cell(adjust=tiny.adjust)
    data, order, dd, model, prog = train.setup(cell)
    del model, dd
    base, stats = train_hard.follow(cell, data, order, prog,
                                    Prec(torch.float64))
    k = len(prog) - 1
    z = base[k]["dual_weight"].numpy()
    loss = base[k]["user_loss"].numpy()
    xi = float(base[k]["xi"])
    tau = cell.limits["tau"]["value"]
    far = int(np.argmax(np.abs(loss - xi)))
    # widen the band so that it holds the users nearest xi
    near = np.argsort(np.abs(loss - xi))[:5]
    wide = max(np.abs(loss[near] - xi) / np.maximum(np.abs(loss[near]),
                                                    abs(xi)))
    cell.limits["tau"]["value"] = float(wide) * 1.0001
    flipped = [dict(s) for s in prog]
    zf = prog[k]["dual_weight"].copy()
    zf[near] = 1.0 - zf[near]
    zf[far] = 1.0 - zf[far]
    flipped[k] = dict(prog[k], dual_weight=zf)
    got, stats = train_hard.follow(cell, data, order, flipped,
                                   Prec(torch.float64))
    assert stats[-1][0] >= near.size and stats[-1][1] == 1
    zg = got[k]["dual_weight"].numpy()
    np.testing.assert_array_equal(zg[near], zf[near])
    assert zg[far] == z[far] != zf[far]
    assert tau < cell.limits["tau"]["value"]


def test_mf_grad_by_hand():
    yard = run.load_module("flops", "mf_grad")
    cfg = {"dim": 4}
    lu, li = np.array([2, 0, 3]), np.array([4, 1])
    # slots 4 d each side, x G 2 d^2 a row with a history, d^2 a user
    want = 4 * 4 * (5 + 5) + 2 * 16 * (2 + 2) + 16 * 3
    assert yard.epoch_flops(cfg, lu, li) == want
    # user side: U read + written (3 rows), V (2) and G read, 5 indices;
    # item side: V read + written, U and G read, 5 indices
    user = 2 * 4 * 4 * 3 + 4 * 4 * 2 + 4 * 16 + 4 * 5
    item = 2 * 4 * 4 * 2 + 4 * 4 * 3 + 4 * 16 + 4 * 5
    assert yard.epoch_bytes(cfg, lu, li) == user + item


class _Span:
    def __init__(self, name, epoch, device_ms):
        self.name, self.epoch, self.device_ms = name, epoch, device_ms


def test_readers_of_the_gradient_sweeps(monkeypatch):
    from portbench.frozen.bounds import bound_ms
    from safer2_recommender_tpu_torch.utils import logging
    roof = run.load_module("metrics", "grad_step.roofline_pct").read
    buckets = run.load_module("metrics", "sweep.grad_buckets.train").read
    recs = [_Span("epoch", k, 100.0) for k in range(2)]
    recs += [_Span("epoch.u_sweep", k, 30.0) for k in range(2)]
    recs += [_Span("epoch.v_sweep", k, 50.0) for k in range(2)]
    monkeypatch.setattr(logging, "spans", lambda: recs)
    trace = {"units": 2, "unit_flops": 6.7e9, "unit_bytes": 1e9}
    assert roof(trace, None) == pytest.approx(
        100.0 * bound_ms(1e9, 6.7e9) / 80.0)
    # no bytes handed in, or a program without the spans: nothing
    assert roof({"units": 2, "unit_flops": 1.0}, None) is None
    monkeypatch.setattr(logging, "spans", lambda: recs[:2])
    assert roof(trace, None) is None
    ops = [("epoch", 0, 1), ("sweep.grad", 0, 1), ("sweep.grad", 0, 1),
           ("epoch", 1, 2), ("sweep.grad", 1, 2), ("sweep.grad", 1, 2)]
    assert buckets({"units": 2, "host_ops": ops}, None) == 2.0
    # the parent's epochs, marked but with no sweep.grad spans
    assert buckets({"units": 2, "host_ops": ops[:1]}, None) is None
    assert buckets({"units": 2, "host_ops": [("aten::mm", 0, 1)]},
                   None) is None


def test_traced_run_tiny_reads_the_buckets():
    """On the CPU the device-ms readers give nothing; the bucket count
    is every bucket of both sweeps."""
    rc, last, err = tiny.run(run, WORKLOAD, trace=1)
    assert rc == 0, err
    assert last["correct"] is True, err
    got = last["metrics"]
    assert "grad_step.roofline_pct" not in got
    assert got["sweep.grad_buckets.train"]["value"] > 0
    assert not {"epoch.loss_ms.train", "epoch.u_sweep_ms.train"} & set(got)


def _controls(device):
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = control_hard.main(["--workload", WORKLOAD, "--seeds",
                                str(tiny.SEED)], device=device,
                               adjust=tiny.adjust)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_controls_tiny():
    """On the CPU the low-precision reference is float32 alone (there is
    no TF32 here). The sound program reads correct true; its bf16 path
    and the planted half batch read false through the run's own judge."""
    got = _controls(torch.device("cpu"))
    limits = set(json.load(open(f"{run.HERE}/limits/{WORKLOAD}.json"))
                 ["limits"])
    for name in control_hard.RUNS:
        assert set(got[name]["checks"]) == limits
        assert len(got[name]["band"]) == 3
    assert got["sound"]["correct"] is True
    assert got["half_batch"]["correct"] is False
    assert got["half_batch"]["checks"]["z_outside_band"]["value"] > 0
    assert got["program_bf16"]["correct"] is False


@pytest.mark.cuda
def test_controls_on_the_card(card):
    """At the test size on the card the sound program reads correct true
    and its bf16 path and the half batch false. The TF32 reference is
    judged at the cell's size alone (the limits file: false on every
    seed there): at dim 128 its few rounded products, x G and the
    Gramians, stay within the limits."""
    got = _controls(card)
    assert got["sound"]["correct"] is True, got["sound"]
    for name in ("program_bf16", "half_batch"):
        assert got[name]["correct"] is False, (name, got[name])


def test_reference_epoch_takes_settle():
    """``settle`` replaces the z-step's indicator before both steps."""
    ref = run.load_module("reference", "cvar_mf")
    cell = _cell(adjust=tiny.adjust)
    users, items, _ = synth.training_set(cell.config["dataset"], 7,
                                         cell.device)
    nu, ni = int(users.max()) + 1, int(items.max()) + 1
    prob = ref.Problem(users, items, nu, ni, cell.config["config"],
                       cell.device, np.arange(nu))
    u0, v0 = train.start_tables(cell, nu, ni)
    st = ref.start_state(prob, u0, v0, Prec(torch.float64))
    ones = ref.epoch(prob, st, None, Prec(torch.float64))
    seen = []
    zeros = ref.epoch(prob, st, None, Prec(torch.float64),
                      settle=lambda loss, xi, z: (seen.append(1),
                                                  torch.zeros_like(z))[1])
    assert seen == [1]
    assert float(ones["dual_weight"].min()) == 1.0
    assert float(zeros["dual_weight"].max()) == 0.0
    # with z = 0 the U step is the ridge's alone
    scale = 1.0 - cell.config["config"]["stepsize"] * ref.safer2.user_reg(
        prob)
    torch.testing.assert_close(zeros["user_emb"], st["user_emb"] * scale,
                               rtol=1e-12, atol=0)
