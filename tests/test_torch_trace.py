"""The spans of the port's training epoch (``utils/logging.py``): off
without a profiler, the documented tree under one, the host syncs and
inverse-Cholesky calls counted where they happen. The test marked
``cuda`` holds the spans to the card: every synchronizing call of an
epoch is a ``host_sync.*`` span, the phases' device ms tile the epoch's,
and the ``kernel.chol_inverse`` spans are the kernel's launches."""

import warnings
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from safer2_recommender_tpu_torch.config import Config
from safer2_recommender_tpu_torch.data.dataset import Dataset, DeviceData
from safer2_recommender_tpu_torch.data.synth import powerlaw_dataset
from safer2_recommender_tpu_torch.models import MODEL_REGISTRY, get_model
from safer2_recommender_tpu_torch.ops import block_chol
from safer2_recommender_tpu_torch.utils.logging import (EPOCH_PHASES,
                                                        clear_spans,
                                                        host_read, span,
                                                        spans)

# where each span opens: the names its parent may have
PARENTS = {
    "epoch": {None},
    **{p: {"epoch"} for p in EPOCH_PHASES},
    "sweep.eigh": {"epoch.u_sweep", "epoch.v_sweep"},
    "sweep.woodbury": {"epoch.u_sweep", "epoch.v_sweep"},
    "sweep.direct": {"epoch.u_sweep", "epoch.v_sweep"},
    "sweep.block": {"epoch.u_sweep", "epoch.v_sweep"},
    "sweep.rotate_table": {"epoch.u_sweep", "epoch.v_sweep"},
    "sweep.grad": {"epoch.u_sweep", "epoch.v_sweep"},
    "kernel.chol_inverse": {"sweep.woodbury", "sweep.direct",
                            "sweep.block"},
    "kernel.grad_gather": {"sweep.grad"},
    "host_sync.eigh": {"sweep.eigh"},
    "host_sync.armijo": {"epoch.xi"},
    "host_sync.scatter": {"epoch.loss", "sweep.woodbury", "sweep.direct",
                          "sweep.block", "sweep.grad"},
}


def _config(dim: int) -> Config:
    # the MSD hyperparameters (sub-sampled Newton steps) at ``dim``;
    # dim 128 takes the Woodbury, rotated and block routes as 512 does
    return Config(dim=dim, uobs_weight=0.0004, l2_reg=0.0012, alpha=0.3,
                  bandwidth=0.1, use_snr=True, sampling_ratio=0.1,
                  block_size=32, seed=0)


def _model(name, dd, num_users, num_items, cfg):
    model = get_model(name, cfg, num_users, num_items, device=dd.device)
    model.initialize(dd)
    model.train_epochs(dd, 1)       # the traced epoch is not the first
    return model


@pytest.fixture(scope="module")
def data():
    ds = Dataset(*powerlaw_dataset(300, 200, mean_hist=30, seed=1))
    return ds, DeviceData.build(ds, device="cpu", dim=128)


@pytest.fixture(scope="module", params=["safer2", "safer2pp"])
def traced(request, data):
    """One epoch of SAFER2 or SAFER2++ under ``torch.profiler`` on the
    CPU: (model, its spans, the profile's event names, the [N, r] of
    every ``chol_inverse_small`` call)."""
    ds, dd = data
    cfg = _config(128)
    model = _model(request.param, dd, ds.num_users, ds.num_items, cfg)
    calls, orig = [], block_chol.chol_inverse_small

    def counted(a, ridge):
        calls.append((int(a.shape[0]), int(a.shape[1])))
        return orig(a, ridge)

    clear_spans()
    block_chol.chol_inverse_small = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.train_epochs(dd, 1)
    finally:
        block_chol.chol_inverse_small = orig
    recs = spans()
    clear_spans()
    return model, recs, [e.name for e in prof.events()], calls


def test_off_without_a_profiler(data):
    ds, dd = data
    clear_spans()
    a, b = span("epoch", dd.device, model="x"), span("sweep.block")
    assert a is b
    with a:
        pass
    x = torch.tensor([1.5, 0.5])
    assert host_read("host_sync.armijo", x.sum() > 1) is True
    assert host_read("host_sync.refresh", x[0]) == 1.5
    _model("safer2", dd, ds.num_users, ds.num_items, _config(128))
    assert spans() == []


def test_epoch_emits_the_documented_tree(traced):
    model, recs, _, _ = traced
    names = [r.name for r in recs]
    assert set(names) <= set(PARENTS)
    assert names[0] == "epoch" and names.count("epoch") == 1
    assert recs[0].attrs == {"model": model.name,
                             "steps": model.state.steps - 1}
    assert [n for n in names if n in EPOCH_PHASES] == list(EPOCH_PHASES)
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        assert (parent and parent.name) in PARENTS[r.name], r.name
        assert r.epoch == 0 and r.end >= r.start
        if parent is not None:
            assert parent.start <= r.start and r.end <= parent.end
        # the CPU times no span on a device
        assert r.device_ms is None
    assert {"sweep.eigh", "host_sync.eigh", "host_sync.armijo",
            "kernel.chol_inverse"} <= set(names)
    assert ("sweep.block" in names) == (model.name == "safer2pp")
    assert ("sweep.woodbury" in names) == (model.name == "safer2")


def test_spans_lie_on_the_profilers_clock(traced):
    # each span is a record_function of its name in the profile, which
    # the benchmark's traced window hands its counters as host ops
    _, recs, events, _ = traced
    assert Counter(r.name for r in recs) == Counter(
        e for e in events if e in PARENTS)


def test_host_syncs_and_chol_inverse_calls_are_counted(traced):
    model, recs, _, calls = traced
    names = Counter(r.name for r in recs)
    # one Armijo test at least in each Newton step of the quantile
    assert names["host_sync.armijo"] >= model.cfg.xi_iterations
    # one eigh a sweep, each with its error check
    assert names["sweep.eigh"] == names["host_sync.eigh"] == 2
    chol = [r for r in recs if r.name == "kernel.chol_inverse"]
    assert len(chol) == len(calls) > 0
    assert sorted((r.attrs["N"], r.attrs["r"]) for r in chol) == \
        sorted(calls)


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY))
def test_every_model_has_an_epoch_span(data, name):
    ds, dd = data
    model = _model(name, dd, ds.num_users, ds.num_items, _config(128))
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        model.train_epoch(dd)
        model.train_epochs(dd, 2)
    recs = spans()
    clear_spans()
    epochs = [r for r in recs if r.name == "epoch"]
    assert [(r.epoch, r.attrs["model"], r.attrs["steps"]) for r in epochs] \
        == [(k, name, model.state.steps - 3 + k) for k in range(3)]
    assert all(r.epoch is not None for r in recs)


def _cvar_mf_epoch(dd, ds, steps_before: int):
    """One profiled CVaR-MF epoch after ``steps_before`` others: (model,
    its spans, the [N, r] of every ``chol_inverse_small`` call)."""
    model = get_model("cvar_mf", _config(128).replace(stepsize=0.4),
                      ds.num_users, ds.num_items, device=dd.device)
    model.initialize(dd)
    model.train_epochs(dd, steps_before)
    calls, orig = [], block_chol.chol_inverse_small

    def counted(a, ridge):
        calls.append((int(a.shape[0]), int(a.shape[1])))
        return orig(a, ridge)

    clear_spans()
    block_chol.chol_inverse_small = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            model.train_epochs(dd, 1)
    finally:
        block_chol.chol_inverse_small = orig
    recs = spans()
    clear_spans()
    return model, recs, calls


@pytest.mark.parametrize("steps_before", [0, 1])
def test_cvar_mf_epoch_emits_its_tree(data, steps_before):
    # the six phases in order (the first epoch's xi is the carried one),
    # a sweep.grad span for each bucket of both sweeps, and no solve
    ds, dd = data
    model, recs, calls = _cvar_mf_epoch(dd, ds, steps_before)
    names = [r.name for r in recs]
    assert set(names) <= set(PARENTS)
    assert names[0] == "epoch" and names.count("epoch") == 1
    assert recs[0].attrs == {"model": "cvar_mf", "steps": steps_before}
    assert [n for n in names if n in EPOCH_PHASES] == list(EPOCH_PHASES)
    for r in recs:
        parent = None if r.parent is None else recs[r.parent]
        assert (parent and parent.name) in PARENTS[r.name], r.name
        if parent is not None:
            assert parent.start <= r.start and r.end <= parent.end
        assert r.device_ms is None
    grads = [r for r in recs if r.name == "sweep.grad"]
    by_side = Counter(recs[r.parent].name for r in grads)
    assert by_side == {"epoch.u_sweep": len(dd.by_user),
                       "epoch.v_sweep": len(dd.by_item)}
    buckets = list(dd.by_user) + list(dd.by_item)
    assert [(r.attrs["rows"], r.attrs["width"]) for r in grads] == [
        (b.n_rows, b.width) for b in buckets]
    assert all(r.attrs["wide"] is False for r in grads)
    assert "kernel.chol_inverse" not in names and calls == []
    assert not {"sweep.eigh", "sweep.woodbury", "sweep.direct",
                "sweep.block", "host_sync.armijo"} & set(names)


def test_cvar_mf_marks_a_wide_bucket(data, monkeypatch):
    # a bucket that streams its history in column chunks says so
    from safer2_recommender_tpu_torch.ops import assemble
    ds, dd = data
    monkeypatch.setattr(assemble, "WIDE_SLAB_BYTES", 1 << 12)
    _, recs, _ = _cvar_mf_epoch(dd, ds, 1)
    grads = [r for r in recs if r.name == "sweep.grad"]
    buckets = list(dd.by_user) + list(dd.by_item)
    wide = [assemble.is_wide(b, 128) for b in buckets]
    assert any(wide)
    assert [r.attrs["wide"] for r in grads] == wide


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["safer2", "safer2pp"])
def test_spans_hold_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device-timed spans and "
                    "synchronizing calls exist only on the card")
    device = torch.device("cuda", 0)
    ds = Dataset(*powerlaw_dataset(20_000, 8_000, mean_hist=40, seed=3))
    dd = DeviceData.build(ds, device=device, dim=512)
    cfg = _config(512).replace(block_size=64)
    model = _model(name, dd, ds.num_users, ds.num_items, cfg)
    torch.cuda.synchronize()
    clear_spans()
    launches = block_chol.total_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model.train_epochs(dd, 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    recs = spans()
    clear_spans()
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    names = Counter(r.name for r in recs)
    assert len(syncs) == sum(n for k, n in names.items()
                             if k.startswith("host_sync."))
    assert names["kernel.chol_inverse"] == \
        block_chol.total_launches() - launches > 0
    epoch = next(r.device_ms for r in recs if r.name == "epoch")
    phases = sum(r.device_ms for r in recs if r.name in EPOCH_PHASES)
    assert epoch > 0 and abs(phases - epoch) <= 0.01 * epoch


@pytest.mark.cuda
def test_cvar_mf_spans_hold_on_the_card():
    # every synchronizing call of a CVaR-MF epoch is a host_sync span,
    # the phases' device ms tile the epoch's, and no solve launches
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device-timed spans and "
                    "synchronizing calls exist only on the card")
    device = torch.device("cuda", 0)
    # large enough that the host's time between the phases, while the
    # device waits, stays under 1% of the epoch (at 20,000 users an
    # epoch is ~65 ms, and that time ~1 ms of it)
    ds = Dataset(*powerlaw_dataset(100_000, 20_000, mean_hist=40, seed=3))
    dd = DeviceData.build(ds, device=device, dim=512)
    cfg = _config(512).replace(stepsize=0.4)
    model = _model("cvar_mf", dd, ds.num_users, ds.num_items, cfg)
    torch.cuda.synchronize()
    clear_spans()
    launches = block_chol.total_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model.train_epochs(dd, 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    recs = spans()
    clear_spans()
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    names = Counter(r.name for r in recs)
    assert len(syncs) == sum(n for k, n in names.items()
                             if k.startswith("host_sync."))
    assert block_chol.total_launches() == launches
    assert names["sweep.grad"] == len(dd.by_user) + len(dd.by_item)
    # every bucket of both sweeps takes the gather-matvec kernel
    assert names["kernel.grad_gather"] == names["sweep.grad"]
    epoch = next(r.device_ms for r in recs if r.name == "epoch")
    phases = sum(r.device_ms for r in recs if r.name in EPOCH_PHASES)
    assert epoch > 0 and abs(phases - epoch) <= 0.01 * epoch
