"""Checkpoint manager: atomic rotation, async writes, restore of the newest
complete step (port of ``repro.checkpoint.manager``).

  * saves are atomic (tmp + rename) — a crash mid-write never corrupts the
    latest checkpoint;
  * ``restore_latest`` ignores partial files, so restart-after-failure
    always finds the newest complete step; given a ``TrainState`` as its
    target it returns one;
  * ``AsyncCheckpointer`` copies the state to the host synchronously and
    serializes and writes it on a thread;
  * the file is mesh-agnostic: on a mesh of ranks, given the state's
    PartitionSpecs (``training.train_loop.state_pspecs``), ``save`` gathers
    every leaf to its whole tensor (``ranks.unshard``) and the mesh's first
    rank writes the blob a single-device save of the same state writes;
    ``restore`` reads the whole tree and keeps this rank's block of each
    leaf under the *new* mesh's specs (elastic re-meshing).  Every rank of
    the mesh calls them; a rank outside it holds no block and gets
    ``None``.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

from repro_torch import tree as trees
from repro_torch.checkpoint import serializer
from repro_torch.distributed import ranks

_CKPT_RE = re.compile(r"^step_(\d+)\.ckpt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mode: str = "zstd"):
        self.directory = directory
        self.keep = keep
        self.mode = mode
        os.makedirs(directory, exist_ok=True)

    # ---- paths ----
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.ckpt")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # ---- save / restore ----
    def save(self, step: int, state: Any, pspecs: Any = None, mesh=None) -> Optional[str]:
        """Write ``state`` as step ``step``; on a mesh of ranks (``pspecs``,
        a tree like ``state``, and ``mesh``) its gathered whole, by the
        mesh's first rank (the others return ``None`` once it is
        published)."""
        if _sharded(mesh):
            if not mesh.is_member:
                return None
            state = _gathered(state, pspecs, mesh)
            path = self._write(step, state) if _first(mesh) else None
            ranks.barrier(mesh)
            return path
        return self._write(step, state)

    def _write(self, step: int, state: Any) -> str:
        data = serializer.serialize(state, mode=self.mode)
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)          # atomic publish
        self._rotate()
        return path

    def restore(self, step: int, target: Any = None, device="cuda", pspecs: Any = None, mesh=None) -> Any:
        """Step ``step``'s tensors on ``device`` (the card unless the caller
        asks for the CPU); see :func:`serializer.deserialize`.  On a mesh
        of ranks, this rank's block of each leaf under ``pspecs`` (a tree
        like ``target``), ``None`` outside the mesh."""
        if _sharded(mesh) and not mesh.is_member:
            return None
        with open(self._path(step), "rb") as f:
            out = serializer.deserialize(f.read(), target, device=device)
        if not _sharded(mesh):
            return out
        return _blocks(out, trees.paths(pspecs), mesh)

    def restore_latest(self, target: Any = None, device="cuda", pspecs: Any = None,
                       mesh=None) -> tuple[Optional[int], Any]:
        steps = self.steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, self.restore(step, target, device=device, pspecs=pspecs, mesh=mesh)

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _first(mesh) -> bool:
    return not any(mesh.coordinate)


def _gathered(state: Any, pspecs: Any, mesh) -> Any:
    """Every tensor leaf of ``state`` gathered to its whole (a collective of
    the mesh), numbers kept."""
    specs = trees.paths(pspecs)
    flat = trees.paths(state)
    return trees.unflatten_like(state, [ranks.unshard(v, specs[k], mesh) if isinstance(v, torch.Tensor) else v
                                        for k, v in flat.items()])


def _blocks(state: Any, specs: dict, mesh) -> Any:
    flat = trees.paths(state)
    return trees.unflatten_like(state, [
        ranks.shard(v, specs[k], mesh).clone(memory_format=torch.contiguous_format)
        if isinstance(v, torch.Tensor) else v for k, v in flat.items()])


def _host_copy(tree: Any) -> Any:
    """A snapshot of ``tree`` on the host: every tensor copied (``.cpu()``
    alone would alias a CPU tensor that the next step updates in place)."""
    return trees.tree_map(
        lambda t: t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t, tree)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, serialize and write on a
    background thread — the train loop does not wait for the disk."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._thread: Optional[threading.Thread] = None
        self._mesh = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, state: Any, pspecs: Any = None, mesh=None) -> None:
        """Wait for the previous write (re-raising its error), copy
        ``state`` to the host, and write it as step ``step`` on a thread.
        On a mesh of ranks the leaves are gathered first (every rank of
        the mesh calls this) and the mesh's first rank writes."""
        self.wait()
        if _sharded(mesh):
            self._mesh = mesh
            if not mesh.is_member:
                return
            state = _gathered(state, pspecs, mesh)
            if not _first(mesh):
                return
        host_state = _host_copy(state)

        def _write():
            try:
                self.manager.save(step, host_state)
            except Exception as e:  # noqa: BLE001 — surfaced by wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise the error of a failed one.
        After a save on a mesh of ranks, every rank of it waits until the
        write is published."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            if mesh.is_member:
                ranks.barrier(mesh)
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
