"""What the readers of the program's own spans share
(``safer2_recommender_tpu_torch/utils/logging.py``, recorded only while
a profiler records, so in the traced window alone): an epoch phase's
device ms, and a count of spans. A program that marks no epoch gives
them nothing to read: each returns None, and the run leaves the metric
out."""

from __future__ import annotations


def phase_ms(trace: dict, name: str):
    """Device ms per epoch of the program's ``name`` spans in the traced
    epochs (the last ``units`` epochs of its ``spans()``); None where it
    records no such span or times none on the device (the CPU)."""
    try:
        from safer2_recommender_tpu_torch.utils.logging import spans
    except ImportError:
        return None
    recs = spans()
    epochs = sorted({s.epoch for s in recs if s.name == "epoch"})
    epochs = set(epochs[-trace["units"]:])
    ms = [s.device_ms for s in recs if s.name == name and s.epoch in epochs]
    if not ms or None in ms:
        return None
    return sum(ms) / trace["units"]


def count(trace: dict, prefix: str):
    """Spans per epoch whose name starts with ``prefix`` among the
    traced window's host ops; None where the program marks no epoch."""
    names = [n for n, _, _ in trace["host_ops"]]
    if "epoch" not in names:
        return None
    return sum(n.startswith(prefix) for n in names) / trace["units"]
