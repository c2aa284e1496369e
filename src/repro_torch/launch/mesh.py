"""Meshes (port of ``repro.launch.mesh``).

``make_host_mesh`` is the one-card mesh, 1×1 ("data", "model") on the
card (or on the CPU when asked).  ``make_rank_mesh`` is a mesh of the
ranks that :func:`repro_torch.distributed.ranks.spawn` started, by axis
names and sizes — (data, model) or (pod, data, model) by default — backed
by one process group a named axis; the train step runs on it
(``training/train_loop.py``).  ``make_production_mesh`` describes the
reference's pods, 16×16 or 2×16×16, with no devices: its specs can be
computed here.
"""
from __future__ import annotations

import math

from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single-pod 16×16 (256 chips, "data","model") or multi-pod 2×16×16
    (512 chips, "pod","data","model") — a descriptor, no devices."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(device="cuda") -> Mesh:
    """One device as a 1×1 (data, model) mesh: the card by default; raises
    without one unless ``device="cpu"``."""
    return Mesh((1, 1), ("data", "model"), device=resolve_device(device))


_RANK_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def make_rank_mesh(axis_sizes, axis_names=None) -> Mesh:
    """A mesh of ranks, e.g. ``make_rank_mesh((2, 2))`` for (data 2,
    model 2) or ``make_rank_mesh((2, 1, 2))`` for (pod 2, data 1, model
    2): every rank of the spawn calls it, and the ranks beyond the mesh's
    size get a mesh they hold no block of (see
    :func:`repro_torch.distributed.ranks.make_mesh`).  ``axis_names``
    defaults to those by the number of sizes."""
    if axis_names is None:
        if len(axis_sizes) not in _RANK_AXES:
            raise ValueError(f"name the axes of a {len(axis_sizes)}-axis mesh")
        axis_names = _RANK_AXES[len(axis_sizes)]
    return ranks.make_mesh(axis_sizes, axis_names)


def chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
