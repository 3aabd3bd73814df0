"""Logging/observability: the JAX package's line formats, a wall-clock
timer that waits for the GPU, and the spans of the training epoch.

The messages are byte-identical to ``safer2_recommender_tpu``'s, so log
parsers read both packages; the logger name differs so one process can
hold both.

Spans (``span``, ``host_read``) mark where the epoch's work happens.
While a ``torch.profiler`` records, each opens a
``torch.profiler.record_function`` of its name, so it lies on the
profiler's clock beside the device kernels (``--profile_dir``'s trace),
and appends a record that ``spans()`` returns. While none records, a
span is one call that returns a shared no-op context. The names, all
fixed strings:

  epoch                       one ``_epoch`` call (``Recommender.
                              train_epochs`` / ``train_epoch``); attrs
                              ``model``, ``steps``; device-timed
    epoch.loss / .xi / .z /   SAFER2's, SAFER2++'s and CVaR-MF's phases,
    .u_sweep / .v_sweep /     in that order (``EPOCH_PHASES``; CVaR-MF's
    .gram                     xi is its exact quantile, its sweeps the
                              gradient steps, the V sweep with its
                              ``U^T diag(z) U``); device-timed
      sweep.eigh              ``woodbury.maybe_eigh``
      sweep.rotate_table      the frozen table's one rotation into the
                              eigenbasis (``models/common.py::
                              rotate_table``); attrs ``rows``
      sweep.woodbury          a bucket of ``solve_sweep``'s Woodbury loop
      sweep.direct            a solve group of ``solve_sweep``
      sweep.block             a bucket of ``block_sweep_frozen``
      sweep.grad              a bucket of CVaR-MF's gradient step
                              (``_grad_step_u``, ``_grad_step_v``): its
                              gather and ``u - eta (A u - rhs)``; attrs
                              ``rows``, ``width``, ``wide``
        kernel.grad_gather    a ``grad_gather`` step's launch (the
                              gather-matvec kernel, on the card); attrs
                              ``rows``, ``width``, ``splits``
        kernel.chol_inverse   a ``block_chol.chol_inverse_small`` call;
                              attrs ``N``, ``r``
  host_sync.<site>            a read of a device value to the host
                              (``host_read``: ``armijo``, ``refresh``,
                              ``cg``), or an aten op that makes one
                              (``eigh``, ``scatter``), wherever it sits
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from typing import List, NamedTuple, Optional

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


# ---- spans -----------------------------------------------------------------

# The device-timed phases of SAFER2's, SAFER2++'s and CVaR-MF's epoch,
# in order.
EPOCH_PHASES = ("epoch.loss", "epoch.xi", "epoch.z", "epoch.u_sweep",
                "epoch.v_sweep", "epoch.gram")

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One span: its ``name``; ``parent``, the index in ``spans()`` of
    the span it opened inside (None at the top); ``epoch``, the index
    among the recorded ``epoch`` spans of the one it lies in (None
    outside any); host ``start`` and ``end`` (``time.perf_counter``
    seconds; ``end`` None while open); ``attrs``; ``device_ms``, the
    stretch of the device's timeline between the span's two CUDA events,
    busy and idle (None for a span timed on the host alone)."""
    name: str
    parent: Optional[int]
    epoch: Optional[int]
    start: float
    end: Optional[float]
    attrs: dict
    device_ms: Optional[float]


class _Log:
    """The spans recorded since ``clear_spans`` in the order they opened,
    the indices of the open ones (innermost last), and the number of
    ``epoch`` spans."""

    def __init__(self):
        self.records: List[_Span] = []
        self.open: List[int] = []
        self.epochs = 0


class _Span:
    """A span while a profiler records (``span``), and its record."""

    __slots__ = ("name", "device", "attrs", "parent", "epoch", "start",
                 "end", "events", "_rf")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.end = self.events = None

    def __enter__(self):
        log = _LOG
        self.parent = log.open[-1] if log.open else None
        if self.name == "epoch":
            self.epoch = log.epochs
            log.epochs += 1
        else:
            self.epoch = (None if self.parent is None
                          else log.records[self.parent].epoch)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        log.open.append(len(log.records))
        log.records.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.end = time.perf_counter()
        _LOG.open.pop()
        self._rf.__exit__(*exc)
        return False

    def device_ms(self) -> Optional[float]:
        if self.events is None or self.end is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


_LOG = _Log()


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context that marks ``name`` (a fixed string) while a
    ``torch.profiler`` records: a ``record_function`` of the name and a
    record for ``spans()`` with ``attrs``. With a CUDA ``device`` the
    record also carries the span's device ms (a CUDA event at each end,
    on the current stream). While no profiler records it returns one
    shared no-op context and allocates, records and calls into CUDA
    nothing."""
    if not _profiling():
        return _OFF
    return _Span(name, device, attrs)


def host_read(name: str, x: torch.Tensor):
    """``x.item()``, the one way the epoch reads a device value to the
    host (a Python bool, float or int); while a profiler records, inside
    the span ``name`` (``"host_sync.<site>"``)."""
    if not _profiling():
        return x.item()
    with _Span(name, None, {}):
        return x.item()


def spans() -> List[Span]:
    """Every span recorded since ``clear_spans``, in the order they
    opened. Reading a device-timed span waits for its closing event."""
    return [Span(s.name, s.parent, s.epoch, s.start, s.end, s.attrs,
                 s.device_ms()) for s in _LOG.records]


def clear_spans() -> None:
    """Forget every recorded span (call it outside any span)."""
    _LOG.records.clear()
    _LOG.open.clear()
    _LOG.epochs = 0
