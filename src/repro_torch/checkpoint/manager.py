"""Checkpoint manager: atomic rotation, restore of the newest complete step
(port of ``repro.checkpoint.manager.CheckpointManager``).

  * saves are atomic (tmp + rename) — a crash mid-write never corrupts the
    latest checkpoint;
  * ``restore_latest`` ignores partial files, so restart-after-failure
    always finds the newest complete step.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

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
