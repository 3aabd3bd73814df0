"""Buckets of the gradient sweeps per epoch in the traced window: the
program's ``sweep.grad`` spans (one a bucket's gather-and-step, either
side). None where the program marks no epoch or no such span."""

from portbench.spans import count


def read(trace: dict, cell):
    n = count(trace, "sweep.grad")
    return n or None
