"""Device ms per epoch of the program's ``epoch.loss`` spans in the
traced epochs: the stretch of the device's timeline, busy and idle,
between the phase's two CUDA events."""

from portbench.spans import phase_ms


def read(trace: dict, cell):
    return phase_ms(trace, "epoch.loss")
