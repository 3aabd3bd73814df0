"""Data-parallel runtime: one process per device over ``torch.distributed``
(the counterpart of ``safer2_recommender_tpu/parallel/mesh.py``).

The layout is the JAX package's SPMD over a 1-D "data" axis: every
bucket's rows (``row_ids``, ``col_ids``, ``length``) are split over the
ranks in contiguous blocks, ``rows // S`` each (as ``P("data")`` splits
them), while the tables U and V, the d x d Gramians, the quantile xi and
the dual weights are replicated. XLA inserted the collectives for the
JAX package; here the port issues them itself, and only through the
functions of this module, so that ``parallel/audit.py`` counts every one:

  * ``all_gather_rows``: each rank's solved rows reach every rank (one
    per sweep), and the per-user metrics and served ids of evaluation
    and serving;
  * ``all_reduce_sum``: a sum whose terms live on different ranks;
  * ``broadcast``: rank 0's initial tables;
  * ``barrier``: a checkpoint written by rank 0 before the others read.

The backend is NCCL for a CUDA mesh and gloo for a CPU one (the CPU
tests); ``backend=`` overrides it. Nothing here changes the backend or
moves a tensor to the CPU on its own.

``mesh=None`` is a single process: ``num_shards`` is 1 and the callers
issue no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from safer2_recommender_tpu_torch.parallel.audit import Traffic
from safer2_recommender_tpu_torch.utils.device import (DEFAULT_DEVICE,
                                                       resolve_device)

# a rank that dies or hangs fails the others' collectives after this
# long instead of hanging them
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the 1-D data-parallel mesh over the default
    process group: the world size, this process's rank and its device.
    ``traffic`` counts the collectives issued through it
    (``parallel/audit.py``)."""

    world_size: int
    rank: int
    device: torch.device
    traffic: Traffic = dataclasses.field(default_factory=Traffic)

    def __post_init__(self):
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of "
                             f"{self.world_size}")


def num_shards(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world_size


def row_range(mesh: Optional[Mesh], rows: int) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` of a padded array of ``rows`` rows: the
    contiguous block ``P("data")`` gives it (all of them without a
    mesh)."""
    s = num_shards(mesh)
    if rows % s:
        raise ValueError(f"{rows} rows do not split over {s} shards")
    if mesh is None:
        return 0, rows
    n = rows // s
    return mesh.rank * n, (mesh.rank + 1) * n


def place(device, mesh: Optional[Mesh]) -> torch.device:
    """The device of an entry point called with ``device`` and ``mesh``:
    ``device`` alone without a mesh, else the mesh's own (which carries
    the rank's CUDA index); a device of another type raises."""
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {str(device)!r} differs from the mesh's "
                         f"{mesh.device}")
    return mesh.device


# --------------------------------------------------------------------------
# Collectives: every one the port issues goes through these four
# --------------------------------------------------------------------------


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of every rank's ``x``, on every rank (in place;
    returns ``x``)."""
    _dist().all_reduce(x)
    mesh.traffic.record("all-reduce", x.numel() * x.element_size())
    return x


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each), concatenated along
    rows in rank order: ``[S * rows, ...]`` on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    _dist().all_gather(parts, x)
    out = torch.cat(parts)
    mesh.traffic.record("all-gather", out.numel() * out.element_size())
    return out


def broadcast(mesh: Mesh, x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (in place; returns ``x``)."""
    _dist().broadcast(x, src)
    mesh.traffic.record("broadcast", x.numel() * x.element_size())
    return x


def barrier(mesh: Mesh) -> None:
    dist = _dist()
    if mesh.device.type == "cuda" and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
    mesh.traffic.record("barrier", 0)


# --------------------------------------------------------------------------
# Process groups
# --------------------------------------------------------------------------


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def get_mesh(device=DEFAULT_DEVICE) -> Mesh:
    """The mesh over the initialized default process group, one device
    per rank: on CUDA this process's current device, which
    ``init_distributed`` and ``spawn`` set to the local rank's."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("get_mesh: torch.distributed is not initialized "
                           "(call parallel.init_distributed first)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world_size=dist.get_world_size(), rank=dist.get_rank(),
                device=dev)


def init_distributed(device=DEFAULT_DEVICE, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the process group and return this rank's ``Mesh``.

    Unset arguments come from torchrun's environment: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and, without ``init_method``,
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``). On CUDA the rank's
    device is ``cuda:<local_rank>`` unless ``device`` names an index
    (``"cuda:0"``: every rank on that card, which only gloo allows), and
    it is made current. The backend is NCCL
    on CUDA and gloo on the CPU unless ``backend`` says otherwise. A
    process whose default group is already initialized (a host that
    set it up itself) keeps it. ``timeout_s`` bounds every collective,
    so a dead rank fails the run instead of hanging it."""
    dist = _dist()
    env = os.environ
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank if rank is not None
                                 else env.get("RANK", 0)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {local_rank} has no CUDA device (this "
                    f"host has {torch.cuda.device_count()})")
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if rank is None:
            rank = int(env["RANK"])
        if world_size is None:
            world_size = int(env["WORLD_SIZE"])
        backend = backend or _default_backend(dev)
        # NCCL binds its communicator to the rank's card up front
        bound = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **bound)
    return get_mesh(dev)


def placement(world_size: int, device=DEFAULT_DEVICE
              ) -> Tuple[str, Optional[str]]:
    """``(device, backend)`` for ``spawn``ing ``world_size`` ranks on
    ``device``: as given (the default backend), except a CUDA device
    without an index when the host has fewer cards than ranks, whose
    ranks all go on ``cuda:0`` over gloo (NCCL refuses two ranks on one
    card). Such ranks share the card: a run of them checks function,
    never scaling."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and dev.index is None
            and world_size > torch.cuda.device_count()):
        return "cuda:0", "gloo"
    return str(dev), None


def shares_a_card(world_size: int, device) -> bool:
    """Whether ``world_size`` ranks spawned on ``device`` (as
    ``placement`` gives it) all run on one card."""
    dev = torch.device(device)
    return dev.type == "cuda" and dev.index is not None and world_size > 1


def _rank_main(rank: int, fn: Callable, world_size: int, device: str,
               backend: Optional[str], init_method: str, timeout_s: float,
               args: tuple, results) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)`` and put
    ``(rank, value)`` on ``results``. An exception ends the process
    non-zero with its traceback, which ``spawn`` re-raises."""
    if torch.device(device).type == "cpu":
        # ranks on one host share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    mesh = init_distributed(device, backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            local_rank=rank, timeout_s=timeout_s)
    results.put((rank, fn(mesh, *args)))
    _dist().destroy_process_group()


def spawn(fn: Callable, world_size: int, device=DEFAULT_DEVICE,
          backend: Optional[str] = None, args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world_size`` fresh processes, one per
    rank, and return their results in rank order.

    The processes start by the ``spawn`` method
    (``torch.multiprocessing.start_processes``; ``fork`` after CUDA has
    been initialized fails), so ``fn``, ``args`` and the results must
    pickle, ``fn`` by its import path. On CUDA rank r runs on
    ``cuda:r``, or every rank on the card ``device`` names by index.
    Rendezvous is a file store in a temporary directory (no port to
    pick). A rank that raises or dies stops every rank and raises
    ``RuntimeError`` with its traceback; so does a run that outlasts
    ``timeout_s``."""
    mp = torch.multiprocessing
    results = mp.get_context("spawn").Queue()
    tmp = tempfile.mkdtemp(prefix="safer2_rdzv_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = mp.start_processes(
        _rank_main, args=(fn, world_size, str(device), backend, init_method,
                          timeout_s, tuple(args), results),
        nprocs=world_size, join=False, start_method="spawn")
    got = {}

    def drain():
        # a rank exits only once its result has left the queue's pipe
        try:
            while True:
                rank, value = results.get_nowait()
                got[rank] = value
        except queue.Empty:
            pass

    deadline = time.monotonic() + timeout_s
    try:
        while not procs.join(timeout=1.0):
            drain()
            if time.monotonic() > deadline:
                raise RuntimeError(f"parallel.spawn: ranks did not finish "
                                   f"within {timeout_s:g} s")
        drain()
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        # join has stopped the other ranks
        raise RuntimeError(f"parallel.spawn: rank {e.error_index} failed:"
                           f"\n{e}") from None
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = sorted(set(range(world_size)) - set(got))
    if missing:
        raise RuntimeError(f"parallel.spawn: ranks {missing} exited without "
                           f"a result")
    return [got[r] for r in range(world_size)]
