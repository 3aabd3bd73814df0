"""Device ms per epoch of the elementwise-and-rest class in the traced
epochs: the broadcast products over gathered history slabs lead it."""

from portbench.frozen.opclasses import CATCH_ALL, classify


def read(trace: dict, cell):
    ms = classify(trace["kernels"])[CATCH_ALL]
    return ms / trace["units"] if ms > 0 else None
