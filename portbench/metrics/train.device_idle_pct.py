"""1 - the union of device-activity intervals over the traced window."""


def read(trace: dict, cell):
    if trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
