"""Calls of the inverse-Cholesky kernel per epoch in the traced window:
the program's ``kernel.chol_inverse`` spans (one a launch)."""

from portbench.spans import count


def read(trace: dict, cell):
    return count(trace, "kernel.chol_inverse")
