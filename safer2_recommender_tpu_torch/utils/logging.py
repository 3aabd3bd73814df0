"""Logging/observability: the JAX package's line formats, and a wall-clock
timer that waits for the GPU.

The messages are byte-identical to ``safer2_recommender_tpu``'s, so log
parsers read both packages; the logger name differs so one process can
hold both.
"""

from __future__ import annotations

import logging
import sys
import time

import torch

LOGGER_NAME = "safer2_recommender_tpu_torch"
_HANDLER = LOGGER_NAME + ".stderr"


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def setup(level: int = logging.INFO, mesh=None) -> logging.Logger:
    """The package logger on stderr, its prefix naming the rank on a
    ``mesh`` (``... safer2_recommender_tpu_torch rank 1/2] msg``)."""
    log = get_logger()
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.name = _HANDLER
        log.addHandler(h)
    where = "" if mesh is None else f" rank {mesh.rank}/{mesh.world_size}"
    for h in log.handlers:
        if h.name == _HANDLER:
            h.setFormatter(logging.Formatter(
                "%(levelname).1s%(asctime)s %(name)s" + where
                + "] %(message)s", datefmt="%m%d %H:%M:%S"))
    # our handler owns these lines; propagating to a configured root
    # logger would emit every line twice in embedding applications
    log.propagate = False
    log.setLevel(level)
    return log


class Timer:
    """Wall-clock span in milliseconds. For a CUDA ``device`` it
    synchronizes before each clock read, so the span covers the work
    queued on the card and not only its enqueue."""

    def __init__(self, device=None):
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = device

    def _now(self) -> float:
        if self._cuda:
            torch.cuda.synchronize(self._device)
        return time.perf_counter()

    def __enter__(self):
        self.start = self._now()
        return self

    def __exit__(self, *exc):
        self.ms = int((self._now() - self.start) * 1000)
        return False
