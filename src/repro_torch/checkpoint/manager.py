"""Checkpoint manager: atomic rotation, async writes, restore of the newest
complete step (port of ``repro.checkpoint.manager``).

  * saves are atomic (tmp + rename) — a crash mid-write never corrupts the
    latest checkpoint;
  * ``restore_latest`` ignores partial files, so restart-after-failure
    always finds the newest complete step; given a ``TrainState`` as its
    target it returns one;
  * ``AsyncCheckpointer`` copies the state to the host synchronously and
    serializes and writes it on a thread.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

from repro_torch import tree as trees
from repro_torch.checkpoint import serializer

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
    def save(self, step: int, state: Any) -> str:
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

    def restore(self, step: int, target: Any = None, device="cuda") -> Any:
        """Step ``step``'s tensors on ``device`` (the card unless the caller
        asks for the CPU); see :func:`serializer.deserialize`."""
        with open(self._path(step), "rb") as f:
            return serializer.deserialize(f.read(), target, device=device)

    def restore_latest(self, target: Any = None, device="cuda") -> tuple[Optional[int], Any]:
        steps = self.steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, self.restore(step, target, device=device)

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


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
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, state: Any) -> None:
        """Wait for the previous write (re-raising its error), copy
        ``state`` to the host, and write it as step ``step`` on a thread."""
        self.wait()
        host_state = _host_copy(state)

        def _write():
            try:
                self.manager.save(step, host_state)
            except Exception as e:  # noqa: BLE001 — surfaced by wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise the error of a failed one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
