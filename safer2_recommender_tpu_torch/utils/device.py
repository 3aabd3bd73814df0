"""The device an entry point runs on.

The port's entry points (``get_model``, ``Recommender``,
``DeviceData.build``, ``FoldInData.build``, the CLI) run on the card
unless the caller asks for the CPU. Without CUDA they raise; they never
fall back to the CPU on their own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """A CUDA device was asked for (or defaulted to) where CUDA is absent."""


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises
    ``DeviceUnavailable`` when ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {str(device)!r}: CUDA is not available (pass "
            f"device=\"cpu\", or --device cpu to the CLI, to run on the CPU)")
    return dev
