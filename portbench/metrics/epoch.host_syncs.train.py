"""Reads of device values to the host per epoch in the traced window:
the program's ``host_sync.*`` spans (each Armijo test of the quantile's
line search, each eigh's error check, ...)."""

from portbench.spans import count


def read(trace: dict, cell):
    return count(trace, "host_sync.")
