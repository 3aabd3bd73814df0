"""Calls of the gradient sweeps' gather-matvec kernel per epoch in the
traced window: the program's ``kernel.grad_gather`` spans (one a
bucket of either sweep, on the card). None where the program marks no
epoch or no such span, as a program without the kernel does."""

from portbench.spans import count


def read(trace: dict, cell):
    n = count(trace, "kernel.grad_gather")
    return n or None
