"""Meshes (port of ``repro.launch.mesh``).

``make_host_mesh`` is the one-card mesh, 1×1 ("data", "model") on the
card (or on the CPU when asked).  ``make_production_mesh`` describes the
reference's pods, 16×16 or 2×16×16, with no devices: its specs can be
computed here, and placing tensors on it waits for the multi-rank slice.
"""
from __future__ import annotations

import math

from repro_torch.device import resolve_device
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


def chips(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
