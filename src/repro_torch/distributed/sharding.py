"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Model code names the axes of parameters and activations *logically*
("batch", "embed", "mlp", "expert", …); a rule table maps each logical
axis to physical mesh axes.  The spec logic is the reference's and needs
no devices: a :class:`Mesh` here is a descriptor of axis names and sizes
(like ``compat.abstract_mesh``), and a :class:`PartitionSpec` is a tuple
that compares equal to the reference's ``P(...)``.

On one card the mesh is 1×1 (``launch.mesh.make_host_mesh``) and every
constraint is the identity.  Inside the ranks of
:func:`repro_torch.distributed.ranks.spawn` a mesh of more devices is
backed by a ``torch.distributed`` ``DeviceMesh`` (one process group a named
axis, and this rank's coordinate on each), which the explicitly collective
code — the sharded fleet and ensemble, the MoE's expert-parallel and
f-sharded bodies, ``compress_psum`` — runs over.  Placing a tensor by its
logical axes on such a mesh (:func:`constrain`, the GSPMD half of the
reference) is the second half of ROADMAP A13a: :func:`constrain` raises
there.

Usage:
    with use_sharding(mesh, rules):
        y = constrain(x, ("batch", None, "tp"))
    pspec = logical_to_pspec(("embed", "mlp"), rules, mesh)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Union

import torch

Logical = Union[str, None]
Rules = dict[str, Union[str, tuple, None]]

MULTI_RANK = (
    "placing tensors by their logical axes over a mesh of more than one "
    "device (constrain, shard_batch, the GSPMD train step) waits for the "
    "second half of ROADMAP A13a"
)

# The reference's rule table (its DESIGN.md §6).
DEFAULT_RULES: Rules = {
    # activation axes
    "batch": ("pod", "data"),
    "act_seq": None,            # sequence dim of activations
    "seq_sp": "model",          # sequence-parallel residual storage (opt-in)
    "act_embed": None,
    "act_heads": "model",
    "act_kv": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "long_cache_seq": "data",   # long-context: shard KV/conv cache over seq
    # parameter axes
    "embed": ("pod", "data"),   # FSDP dim of weight matrices
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "expert": "model",          # expert-parallel dim
    "expert_in": ("pod", "data"),
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,             # stacked leading axis
    "norm": None,
}


class PartitionSpec(tuple):
    """A tuple of mesh-axis entries, one a dimension: ``None``, an axis
    name, or a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes of a device mesh; ``device`` is where this rank
    (or a 1-device mesh) places tensors, ``None`` for a descriptor with no
    devices.  A mesh of ranks (:func:`repro_torch.distributed.ranks.make_mesh`)
    also carries its ``DeviceMesh`` and this rank's ``coordinate`` on each
    axis (``None`` on a rank outside the mesh)."""

    axis_sizes: tuple
    axis_names: tuple
    device: Optional[torch.device] = None
    device_mesh: Any = dataclasses.field(default=None, compare=False, repr=False)
    coordinate: Optional[tuple] = None

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and names {self.axis_names} differ in length")
        if self.coordinate is None and self.size == 1:
            object.__setattr__(self, "coordinate", (0,) * len(self.axis_sizes))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def is_member(self) -> bool:
        """Whether this rank holds a block of the mesh."""
        return self.coordinate is not None

    def index(self, axes) -> int:
        """This rank's block index along one axis or several (major to
        minor): the position of its block in a dimension sharded over them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.coordinate is None:
            raise ValueError(f"this rank holds no block of the {self.shape} mesh")
        i = 0
        for a in axes:
            k = self.axis_names.index(a)
            i = i * self.axis_sizes[k] + self.coordinate[k]
        return i


@dataclasses.dataclass
class _ShardCtx:
    mesh: Optional[Mesh] = None
    rules: Optional[Rules] = None


_ctx = threading.local()


def _get() -> _ShardCtx:
    if not hasattr(_ctx, "v"):
        _ctx.v = _ShardCtx()
    return _ctx.v


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh], rules: Optional[Rules] = None):
    """Install mesh+rules for `constrain` calls inside model code."""
    prev = _get().mesh, _get().rules
    _get().mesh, _get().rules = mesh, rules if rules is not None else DEFAULT_RULES
    try:
        yield
    finally:
        _get().mesh, _get().rules = prev


def current_mesh() -> Optional[Mesh]:
    return _get().mesh


def current_rules() -> Rules:
    return _get().rules or DEFAULT_RULES


def logical_to_pspec(
    axes: Sequence[Logical],
    rules: Optional[Rules] = None,
    mesh: Optional[Mesh] = None,
    shape: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Map logical axes to a PartitionSpec.

    Drops mesh axes that (a) are absent from the mesh, (b) do not divide the
    corresponding dimension (when ``shape`` is given — e.g. hubert's
    vocab=504 on a 16-wide model axis), or (c) were already consumed by an
    earlier dimension (a spec may use each mesh axis once)."""
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    used: set[str] = set()
    out = []
    for i, ax in enumerate(axes):
        phys = rules.get(ax, None) if ax is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        dim = shape[i] if shape is not None else None
        chosen: list[str] = []
        prod = 1
        for p in phys:
            if p not in mesh_axes or p in used:
                continue
            size = mesh.shape[p]
            if dim is not None and dim % (prod * size) != 0:
                continue
            chosen.append(p)
            prod *= size
        used.update(chosen)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    while out and out[-1] is None:      # canonical form: no trailing Nones
        out.pop()
    return PartitionSpec(*out)


def constrain(x: torch.Tensor, axes: Sequence[Logical]) -> torch.Tensor:
    """The identity with no mesh or on a one-device mesh; raises on a mesh
    of more devices (the second half of ROADMAP A13a)."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(f"constrain{tuple(axes)} on a {mesh.shape} mesh: {MULTI_RANK}")


def axis_size(logical: str, mesh: Optional[Mesh] = None) -> int:
    """Product of mesh-axis sizes a logical axis maps onto.

    Requires an active mesh — passed explicitly or installed via
    :func:`use_sharding`; without one it raises, naming the logical axis,
    rather than silently answering 1."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(
            f"axis_size({logical!r}) needs an active mesh: none was passed "
            "and no mesh is installed — wrap the call in "
            "use_sharding(mesh, rules) or pass mesh= explicitly"
        )
    phys = current_rules().get(logical)
    if phys is None:
        return 1
    if isinstance(phys, str):
        phys = (phys,)
    n = 1
    for p in phys:
        if p in mesh.axis_names:
            n *= mesh.shape[p]
    return n


def divisible(dim: int, logical: str, mesh: Optional[Mesh] = None) -> bool:
    """Whether ``dim`` divides evenly over ``logical``'s shard count; raises
    like :func:`axis_size` with no active mesh."""
    if mesh is None and current_mesh() is None:
        raise ValueError(
            f"divisible(dim={dim}, logical={logical!r}) needs an active "
            "mesh: none was passed and no mesh is installed — wrap the "
            "call in use_sharding(mesh, rules) or pass mesh= explicitly"
        )
    return dim % axis_size(logical, mesh) == 0
