"""The whole step's share of the card's float32 peak (67 TFLOP/s
outside the tensor cores; the configuration computes in float32 with
TF32 off): the configuration's model FLOPs (``portbench/flops/``) of the
epochs of the untraced window over the window's time."""

from portbench.frozen.bounds import F32_FLOP_PER_S


def read(trace: dict, cell):
    if cell.device.type != "cuda":
        return None
    flops = trace["unit_flops"] * trace["main_units"]
    return 100.0 * flops / (trace["main_window_s"] * F32_FLOP_PER_S)
