"""Checkpoint and resume of a model state (the counterpart of
``safer2_recommender_tpu/checkpoint.py``, npz backend only: orbax is a
JAX package).

Layout, the JAX package's npz fallback, so a directory written by either
package restores into the other:

  * ``state_{epoch}.npz``: one array per ``MFState`` field;
  * ``meta_{epoch}.npz``: the id-space sidecar of format v2
    (``Recommender.checkpoint_meta``: ``format_version``, ``user_order``,
    ``item_order``, ``dd_fp``), which makes a checkpoint self-contained:
    a fresh process evaluates, serves and exports in original ids
    without rebuilding the training DeviceData;
  * ``latest.json``: ``{"epoch": n}``.

The newest three of each kind are kept. The saved tables are in the
solver-order id space of the DeviceData they were trained against.

The port's ``steps`` is a Python int (saved as an int64 scalar) and its
random stream a ``torch.Generator`` on the model, whose state is saved as
``generator_state`` (uint8) beside the fields when ``save`` is given the
generator, so that a resumed run draws what a continued run draws (the
JAX package keeps a PRNG ``key`` field instead; the port ignores it).

On a mesh the state is replicated, so rank 0 writes, a barrier follows,
and then every rank may restore the same files.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from safer2_recommender_tpu_torch.parallel import mesh as mesh_lib
from safer2_recommender_tpu_torch.utils.logging import LOGGER_NAME

_log = logging.getLogger(LOGGER_NAME)

GENERATOR_KEY = "generator_state"


def _field_dict(state) -> dict:
    """Shallow {name: leaf} view of a dataclass state."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)}


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, int):
        return np.int64(value)
    return np.asarray(value)


def _put_like(value: np.ndarray, template):
    """A restored leaf as the template's kind: a tensor on the template's
    device and of its dtype, or a Python int for ``steps``."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(value)).to(
            device=template.device, dtype=template.dtype)
    return type(template)(value)


class CheckpointManager:
    """Save/restore model states keyed by epoch; on ``mesh`` (the model's)
    rank 0 writes and every rank waits for it."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def save(self, state, epoch: int, meta: Optional[dict] = None,
             generator: Optional[torch.Generator] = None) -> None:
        """Persist ``state``, the id-space ``meta`` from
        ``Recommender.checkpoint_meta()`` and, when given, the state of
        ``generator`` (the model's ``torch.Generator``). On a mesh only
        rank 0 writes; every rank returns once the files are complete."""
        if self.mesh is None or self.mesh.rank == 0:
            self._write(state, epoch, meta, generator)
        if self.mesh is not None:
            mesh_lib.barrier(self.mesh)

    def _write(self, state, epoch: int, meta: Optional[dict],
               generator: Optional[torch.Generator]) -> None:
        leaves = {k: _to_numpy(v) for k, v in _field_dict(state).items()}
        if generator is not None:
            leaves[GENERATOR_KEY] = generator.get_state().numpy()
        np.savez(os.path.join(self.directory, f"state_{epoch}.npz"),
                 **leaves)
        with open(os.path.join(self.directory, "latest.json"), "w") as f:
            json.dump({"epoch": epoch}, f)
        if meta is not None:
            np.savez(os.path.join(self.directory, f"meta_{epoch}.npz"),
                     **meta)
        self._prune_npz("state", keep=3)
        self._prune_npz("meta", keep=3)
        _log.info("Saved checkpoint at epoch %d", epoch)

    def _prune_npz(self, prefix: str, keep: int) -> None:
        paths = glob.glob(os.path.join(self.directory, f"{prefix}_*.npz"))
        by_epoch = sorted(
            paths, key=lambda p: int(
                os.path.basename(p)[len(prefix) + 1:-len(".npz")]))
        for p in by_epoch[:-keep]:
            os.remove(p)

    def restore_meta(self, epoch: int) -> Optional[dict]:
        """Id-space sidecar of ``epoch`` (None on pre-v2 checkpoints)."""
        path = os.path.join(self.directory, f"meta_{epoch}.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

    def latest_epoch(self) -> Optional[int]:
        path = os.path.join(self.directory, "latest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)["epoch"]

    def restore_with_meta(
            self, template_state,
            generator: Optional[torch.Generator] = None
    ) -> Tuple[Optional[object], int, Optional[dict]]:
        """``restore`` plus the id-space sidecar: returns
        (state or None, start_epoch, meta or None). Feed the meta to
        ``Recommender.load_checkpoint_meta``."""
        state, epoch = self.restore(template_state, generator=generator)
        meta = self.restore_meta(epoch) if state is not None else None
        return state, epoch, meta

    def restore(self, template_state,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Optional[object], int]:
        """Restore the newest checkpoint shaped like ``template_state``;
        returns (state or None, start_epoch). Tensors land on the
        template's device. A field the file lacks is taken from the
        template; one the port does not know (the JAX ``key``) is
        ignored. ``generator`` gets the saved generator state, when the
        file has one of its kind."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None, 0
        tpl = _field_dict(template_state)
        with np.load(os.path.join(self.directory,
                                  f"state_{epoch}.npz")) as data:
            restored = {k: data[k] for k in tpl if k in data.files}
            gen_state = (data[GENERATOR_KEY]
                         if GENERATOR_KEY in data.files else None)
        for k in tpl:
            if k not in restored:
                _log.info("Checkpoint lacks field %r; using template", k)
                restored[k] = _to_numpy(tpl[k])
        state = type(template_state)(**{
            k: _put_like(restored[k], tpl[k]) for k in tpl})
        if generator is not None and gen_state is not None:
            if gen_state.size == generator.get_state().numel():
                generator.set_state(torch.from_numpy(gen_state.copy()))
            else:
                _log.info("Checkpoint's generator state is of another "
                          "device's generator; keeping this one")
        return state, epoch
