"""Meshes (port of ``repro.launch.mesh``).

``make_host_mesh`` is the one-card mesh, 1×1 ("data", "model") on the
card (or on the CPU when asked).  ``make_rank_mesh`` is a mesh of the
ranks that :func:`repro_torch.distributed.ranks.spawn` started, by axis
names and sizes, backed by one process group a named axis.
``make_production_mesh`` describes the reference's pods, 16×16 or
2×16×16, with no devices: its specs can be computed here, and placing
tensors on it by their logical axes waits for the second half of ROADMAP
A13a.
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


def make_rank_mesh(axis_sizes, axis_names=("data", "model")) -> Mesh:
    """A mesh of ranks, e.g. ``make_rank_mesh((2, 2))`` for (data 2,
    model 2): every rank of the spawn calls it, and the ranks beyond the
    mesh's size get a mesh they hold no block of (see
    :func:`repro_torch.distributed.ranks.make_mesh`)."""
    return ranks.make_mesh(axis_sizes, axis_names)


def chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
