"""The gradient sweeps' share of their roofline in the traced epochs:
the least time of one epoch's two gradient steps (``frozen/bounds.py``
at the configuration's model FLOPs and compulsory bytes,
``portbench/flops/``, which the driver hands in the trace) over the
device ms of the program's ``epoch.u_sweep`` and ``epoch.v_sweep``
spans an epoch. None where the program has no such spans, where they
are not timed on a device (the CPU), or where the driver hands no
bytes."""

from portbench.frozen.bounds import bound_ms
from portbench.spans import phase_ms


def read(trace: dict, cell):
    if "unit_bytes" not in trace:
        return None
    u = phase_ms(trace, "epoch.u_sweep")
    v = phase_ms(trace, "epoch.v_sweep")
    if u is None or v is None or u + v <= 0:
        return None
    return 100.0 * bound_ms(trace["unit_bytes"], trace["unit_flops"]) / (
        u + v)
