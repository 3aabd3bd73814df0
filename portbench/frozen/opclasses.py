"""The op-class table of a device trace, and the device-busy union.

Origin (copied at commit fcae2312b1ea72c586087e9a4a161dd4d15691d9):
``safer2_recommender_tpu_torch/probes/epoch_profile.py`` (``CLASSES``,
``op_class``, ``kernel_rows``, ``device_events``, ``busy_ms``, the
launching-op rule for eigh), itself after ``scripts/trace_classes.py:16-28``.
Each device kernel belongs to the aten op that launched it (the
profiler's CPU parent; kernel names differ between cuBLAS versions), or
to the library routine around that op (eigh); a kernel no aten op
launched is classed by its name.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

CLASSES = ("gather (slab rows)", "scatter (writeback)", "chol_inverse",
           "eigh", "batched Gramian products", "batched rhs products",
           "other GEMMs", "reductions", "dtype and layout copies",
           "elementwise and the rest")
CATCH_ALL = CLASSES[-1]
GEMM_CLASSES = ("batched Gramian products", "batched rhs products",
                "other GEMMs")
OVERHEAD = ("Buffer Flush", "Activity Buffer Request")
_GATHER = {"aten::index", "aten::index_select", "aten::gather",
           "aten::take", "aten::embedding"}
_SCATTER = {"aten::index_put_", "aten::_index_put_impl_", "aten::index_put",
            "aten::index_copy_", "aten::index_copy", "aten::index_add_",
            "aten::index_add", "aten::scatter_", "aten::scatter",
            "aten::scatter_add_", "aten::scatter_add",
            "aten::scatter_reduce_", "aten::masked_scatter_"}
_BATCHED = {"aten::bmm", "aten::baddbmm"}
_GEMM = {"aten::mm", "aten::addmm", "aten::matmul", "aten::mv",
         "aten::addmv", "aten::dot", "aten::linear", "aten::_addmm_activation"}
_REDUCTION = {"aten::sum", "aten::mean", "aten::norm",
              "aten::linalg_vector_norm", "aten::cumsum", "aten::amax",
              "aten::amin", "aten::max", "aten::min", "aten::prod",
              "aten::any", "aten::all", "aten::argmax", "aten::argmin",
              "aten::std", "aten::var", "aten::logsumexp",
              "aten::count_nonzero"}
_COPY = {"aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
         "aten::contiguous"}


class KernelRow(NamedTuple):
    """Device kernels of one launching op (None: no aten op launched
    them), the op's input shapes, the kernel's name, ms and launches."""
    op: Optional[str]
    shapes: tuple
    kernel: str
    ms: float
    launches: int = 1


def _batched_vector(shapes) -> bool:
    """Is a ``bmm`` / ``baddbmm`` on these shapes a batch of
    matrix-vector products (a result [N, m, 1] or [N, 1, n])?"""
    mats = [s for s in shapes if len(s) == 3]
    if len(mats) < 2:
        return False
    a, b = mats[-2:]
    return a[1] == 1 or b[2] == 1


def op_class(op: Optional[str], shapes, kernel: str) -> str:
    if kernel.startswith(("Memcpy", "Memset")):
        return "dtype and layout copies"
    if op is None:
        return "chol_inverse" if "chol_inverse" in kernel else CATCH_ALL
    if "eigh" in op:
        return "eigh"
    if op in _GATHER:
        return "gather (slab rows)"
    if op in _SCATTER:
        return "scatter (writeback)"
    if op in _BATCHED:
        return ("batched rhs products" if _batched_vector(shapes)
                else "batched Gramian products")
    if op in _GEMM:
        return "other GEMMs"
    if op in _REDUCTION:
        return "reductions"
    if op in _COPY:
        return "dtype and layout copies"
    return CATCH_ALL


def classify(rows: Sequence[KernelRow]) -> Dict[str, float]:
    """ms by class; the classes sum to the rows' total."""
    out = {c: 0.0 for c in CLASSES}
    for r in rows:
        out[op_class(r.op, r.shapes, r.kernel)] += r.ms
    return out


def event_ms(e) -> float:
    return (e.time_range.end - e.time_range.start) / 1e3


def device_events(events):
    """The device activity of a profile's events: kernels, copies and
    sets, without CUPTI's bookkeeping or user annotations."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.name not in OVERHEAD]


def _launching_op(event) -> str:
    e = event
    while e is not None:
        if e.name.startswith("aten::") and "eigh" in e.name:
            return e.name
        e = e.cpu_parent
    return event.name


def kernel_rows(events) -> List[KernelRow]:
    """Every device kernel of a profile's events as a ``KernelRow``: the
    kernels each aten op launched, then, by kernel name, the device time
    no aten op launched."""
    from torch.autograd import DeviceType

    device = defaultdict(lambda: [0.0, 0])
    for e in device_events(events):
        device[e.name][0] += event_ms(e)
        device[e.name][1] += 1
    rows, linked, seen = [], defaultdict(lambda: [0.0, 0]), set()
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels
                or not e.name.startswith("aten::") or e.id in seen):
            continue
        seen.add(e.id)
        op = _launching_op(e)
        shapes = tuple(tuple(s) for s in e.input_shapes or ())
        for k in e.kernels:
            if k.name in OVERHEAD:
                continue
            rows.append(KernelRow(op, shapes, k.name, k.duration / 1e3))
            linked[k.name][0] += k.duration / 1e3
            linked[k.name][1] += 1
    for name, (ms, n) in device.items():
        rest_ms, rest_n = ms - linked[name][0], n - linked[name][1]
        if rest_n > 0:
            rows.append(KernelRow(None, (), name, rest_ms, rest_n))
    return rows


def union_ms(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle gaps of ``intervals`` inside [lo, hi]."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]
