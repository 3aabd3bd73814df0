"""One gradient step of CVaR-MF's bucket rows in one hand-written
gather-matvec kernel (``csrc/grad_gather.cu``).

For a bucket of rows with histories ``col_ids`` (padded to ``width``
slots, ``length`` real), the frozen table ``other``, the rows' current
values ``x`` in ``self`` and the frozen Gramian ``G``::

    h = sum over l < length of  s (v_l . x - 1) v_l,   v_l = other[col]
    x <- x - eta (c0 x + c1 (x @ G) + h)                 (in place)

in the two forms CVaR-MF's steps take (``models/cvar_mf.py``):

* ``user_step``: ``s = w / max(length, 1)``, ``c0`` the scalar ridge,
  ``c1 = uobs w``, with ``w = dual[row]`` the dual weight
  (``models/common.py::params_weighted_mean``);
* ``item_step``: ``s = norm_dual[col]``, ``c0 = reg[row]`` the item's
  ridge, ``c1 = uobs`` (``params_weighted_item``).

In both, ``wt`` and ``r`` of the plain route are one weight, so its
``A_hist x - rhs`` is ``h``, here without the [N, L, d] slab. Each real
slot's row is read once (twice past d = 1,024); nothing of the slab's
size is written; the rows are read and written back as
``assemble.read_rows`` and ``assemble.scatter_bucket`` do. ``x @ G``, a
plain large product, is a torch.matmul.

``applies`` says whether a frozen table takes this route: every CUDA
float32 table, at any width and layout. Everything else keeps the plain
route of ``grad_from_params`` bit for bit: the CPU, where the tests hold
the port to the JAX package, and a bfloat16 assembly dtype, whose
rounding follows ``assemble.weight_operand``. The steps raise for any
input the kernel does not take (a CPU tensor, a table that is not
float32 or not contiguous) and never fall back. Each launch is a
``kernel.grad_gather`` span (attrs ``rows``, ``width``, ``splits``);
``LAUNCHES`` counts them.
"""

from __future__ import annotations

import ctypes
import os

import torch

from safer2_recommender_tpu_torch import native
from safer2_recommender_tpu_torch.data.dataset import Bucket
from safer2_recommender_tpu_torch.ops import assemble, woodbury
from safer2_recommender_tpu_torch.utils.logging import span

# Slots one block sums: a row longer than this is split over blocks,
# whose partials a second kernel sums in order.
CHUNK = 1024
# Columns a warp holds in registers; a wider row takes the two-pass route
# (each slot's dot first, then the columns in tiles of this width).
MAX_COLS = 1024
MAX_SPLITS = 65535    # the grid's second dimension
_SRC = os.path.join(native.CSRC_DIR, "grad_gather.cu")

# Kernel launches; a launch adds one, nothing else does.
LAUNCHES = 0

_lib = None


def build_kernel():
    """Compile (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = native.build_cuda("grad_gather", [_SRC])
        lib.frt_grad_gather_f32.restype = ctypes.c_int
        lib.frt_grad_gather_f32.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 6
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        _lib = lib
    return _lib


def applies(table: torch.Tensor) -> bool:
    """Does a gradient step gathering from ``table`` take the kernel?"""
    return table.is_cuda and table.dtype == torch.float32


def splits(width: int) -> int:
    """Blocks a row of ``width`` slots is split over."""
    return max(1, -(-width // CHUNK))


def _check(self, other, bucket, gram, c0, weight, vec) -> None:
    tensors = {"self": self, "other": other, "gram": gram}
    for name, t in (("c0", c0), ("weight", weight), ("vec", vec)):
        if torch.is_tensor(t):
            tensors[name] = t
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"grad_gather: {name} must be float32, got "
                            f"{t.dtype}")
    if other.device.type != "cuda":
        raise ValueError(f"grad_gather: no kernel for {other.device}; the "
                         f"plain route is grad_from_params's")
    d = other.shape[1]
    for name in ("self", "other"):
        t = tensors[name]
        if t.dim() != 2 or t.shape[1] != d or not t.is_contiguous():
            raise ValueError(f"grad_gather: {name} must be a contiguous "
                             f"[R, {d}]")
    if tuple(gram.shape) != (d, d):
        raise ValueError(f"grad_gather: gram must be [{d}, {d}]")
    for name in ("c0", "weight", "vec"):
        if name in tensors and (tensors[name].dim() != 1
                                or tensors[name].shape[0] == 0
                                or not tensors[name].is_contiguous()):
            raise ValueError(f"grad_gather: {name} must be a contiguous, "
                             f"non-empty 1-D vector")
    ids = (bucket.col_ids, bucket.length, bucket.row_ids)
    if any(t.dtype != torch.int64 or not t.is_contiguous() for t in ids):
        raise TypeError("grad_gather: contiguous int64 bucket arrays only")
    if any(t.device != other.device for t in list(tensors.values()) +
           list(ids)):
        raise ValueError("grad_gather: every input on one device")


def user_step(ue: torch.Tensor, item_emb: torch.Tensor, bucket: Bucket,
              gram: torch.Tensor, eta: float, *, reg: float, uobs: float,
              dual: torch.Tensor) -> torch.Tensor:
    """CVaR-MF's user step of ``bucket``'s rows of ``ue``, in place,
    gathering from ``item_emb``: the ridge ``reg`` and the dual weight
    ``dual`` by row id. Returns ``ue``."""
    return _step(ue, item_emb, bucket, gram, eta, c0=float(reg), c1=uobs,
                 weight=dual)


def item_step(v: torch.Tensor, user_emb: torch.Tensor, bucket: Bucket,
              gram: torch.Tensor, eta: float, *, reg: torch.Tensor,
              uobs: float, norm_dual: torch.Tensor) -> torch.Tensor:
    """CVaR-MF's item step of ``bucket``'s rows of ``v``, in place,
    gathering from ``user_emb``: the ridges ``reg`` by row id and the
    normalized dual weight ``norm_dual`` by column id. Returns ``v``."""
    return _step(v, user_emb, bucket, gram, eta, c0=reg, c1=uobs,
                 vec=norm_dual)


def _step(self, other, bucket, gram, eta, *, c0, c1, weight=None,
          vec=None) -> torch.Tensor:
    """One launch; a wide bucket's rows are counted in
    ``woodbury.SOLVE_PATHS``."""
    global LAUNCHES
    _check(self, other, bucket, gram, c0, weight, vec)
    n, width, d = bucket.n_rows, bucket.width, other.shape[1]
    k = splits(width)
    if k > MAX_SPLITS:
        raise ValueError(f"grad_gather: width {width} needs {k} chunks, "
                         f"over {MAX_SPLITS}")
    if assemble.is_wide(bucket, d):
        woodbury.SOLVE_PATHS["wide"] += n
    if n == 0:
        return self
    xg = assemble.read_rows(self, bucket) @ gram
    c0_vec = c0 if torch.is_tensor(c0) else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with span("kernel.grad_gather", rows=n, width=width, splits=k):
        empty = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                           device=other.device)
        part = empty(k, n, d) if k > 1 else None
        dots = empty(n, width) if d > MAX_COLS else None
        lib = build_kernel()
        with torch.cuda.device(other.device):
            stream = torch.cuda.current_stream(other.device).cuda_stream
            err = lib.frt_grad_gather_f32(
                other.data_ptr(), bucket.col_ids.data_ptr(),
                bucket.length.data_ptr(), bucket.row_ids.data_ptr(),
                self.data_ptr(), xg.data_ptr(), ptr(weight), ptr(c0_vec),
                ptr(vec), ptr(part), ptr(dots), n, width, self.shape[0],
                bucket.row_start if bucket.contiguous else -1,
                0 if weight is None else weight.shape[0],
                0 if c0_vec is None else c0_vec.shape[0],
                0.0 if c0_vec is not None else c0, c1, eta, d, CHUNK, k,
                stream)
        if err != 0:
            raise RuntimeError(
                f"grad_gather kernel launch failed at [N={n}, width={width}, "
                f"d={d}]: cudaError {err}")
        LAUNCHES += 1
    return self
