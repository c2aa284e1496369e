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
axis, and this rank's coordinate on each), over which the explicitly
collective code runs: the sharded fleet and ensemble, the MoE's
expert-parallel and f-sharded bodies, ``compress_psum`` and the GSPMD
train step (``training/train_loop.py``).

**Placing by logical axes on a mesh of ranks.**  Eager torch has no
sharding propagation: a tensor does not know its layout, so there is
nothing for ``with_sharding_constraint`` to re-lay.  The port's model code
works on *local blocks* and moves between layouts with explicit
collectives (:class:`Layout`: FSDP's weight gather, the tensor-parallel
pair, the vocab-parallel sums).  :func:`constrain` is therefore an
**assertion**: on a mesh of more than one device it checks that the local
block has the shape ``logical_to_pspec(axes, shape=global)`` implies for
the global ``shape`` the caller names, raises ``ValueError`` if not, and
returns the block unchanged.  Every ``constrain`` of the reference's dense
decoder has its counterpart at the same place of the port's.  One departs
from the reference's layout, with the same numbers: where the KV heads
divide over ``model``, each rank keeps only the KV heads its query heads
read (``("batch", "act_seq", "act_heads", None)``) where the reference
replicates them (``"act_kv"``).  The serving step runs on the same
:class:`Layout` (``model_zoo.serving_layout``), whose batch may be
replicated (``replicated_batch``: a batch that does not divide over (pod,
data), as long_500k's one row); a decode state's KV cache is a local
block, its batch over (pod, data) (``cache_batch``), its sequence whole or
split as the rule ``cache_seq`` / ``long_cache_seq`` says
(:meth:`Layout.seq_axes`), and its heads the KV heads this rank's query
heads read (``models/attention.py::cache_heads``), where the reference
keeps all, or every KV head where ``model`` splits the sequence.

Usage:
    with use_sharding(mesh, rules):
        y = constrain(x, ("batch", None, "tp"), shape=global_shape)
    pspec = logical_to_pspec(("embed", "mlp"), rules, mesh)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional, Sequence, Union

import torch

from repro_torch.distributed import ranks
from repro_torch.tree import paths, unflatten_like

Logical = Union[str, None]
Rules = dict[str, Union[str, tuple, None]]

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


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_shape(shape: Sequence[int], pspec: PartitionSpec, mesh: Mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under ``pspec``."""
    out = list(shape)
    for dim, entry in enumerate(pspec):
        out[dim] //= math.prod(mesh.shape[a] for a in _entry_axes(entry))
    return tuple(out)


def constrain(
    x: torch.Tensor,
    axes: Sequence[Logical],
    shape: Optional[Sequence[int]] = None,
    mesh: Optional[Mesh] = None,
    rules: Optional[Rules] = None,
) -> torch.Tensor:
    """``x`` unchanged.  With no mesh or on a one-device mesh that is all;
    on a mesh of more devices ``x`` is this rank's block of a tensor of the
    global ``shape``, and its shape must be the block ``axes`` imply
    (``logical_to_pspec(axes, rules, mesh, shape)``), else ``ValueError``
    (see the module docstring)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    if shape is None:
        raise ValueError(f"constrain{tuple(axes)} on a {mesh.shape} mesh needs the global shape of the block")
    pspec = logical_to_pspec(axes, rules, mesh, shape)
    want = block_shape(shape, pspec, mesh)
    if tuple(x.shape) != want:
        raise ValueError(
            f"constrain{tuple(axes)}: a block of the global {tuple(shape)} under {pspec} on a "
            f"{mesh.shape} mesh is {want}, got {tuple(x.shape)}"
        )
    return x


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


# ---------------------------------------------------------------------------
# Parameters held as blocks by a train step on a mesh of ranks
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Layout:
    """How a train step on a mesh of ranks holds a model's parameters and
    runs its forward on local blocks (``training/train_loop.py``).

    Each parameter is stored as this rank's block under its PartitionSpec
    (``pspecs``, by tree path).  Before use a block is gathered over its
    FSDP axes (every axis of its spec but ``tp``): :meth:`fetch` does it
    where the weight is used, per microbatch and per remat replay, with an
    autograd gather whose backward sums the ranks' gradients back into the
    blocks; with ``gathered`` the step did it once (:meth:`gather_all`) and
    reduces the gradients once (:meth:`reduce_all`).  The ``tp`` (model)
    axis stays split in use: heads, ``d_ff`` and vocab are local, and
    :meth:`enter` / :meth:`exit` are the tensor-parallel pair around each
    region whose ranks each compute a part.

    Each rank's loss is its rows' share of the global mean, so the step's
    gradient is the sum of the ranks' over ``batch_axes`` (the axes the
    batch rows are split over): every leaf's gradient is summed over those
    axes, inside :meth:`fetch`'s backward or in :meth:`reduce_all`.  A
    train step's layout says so (``training``), for the one term whose
    share a serving step does not need: the MoE's aux loss
    (``models/moe.py``)."""

    mesh: Mesh
    rules: Rules
    pspecs: dict                 # {tree path: PartitionSpec of the stored block}
    gathered: bool = False
    replicated_batch: bool = False   # every rank holds the whole batch (a serving step's)
    training: bool = False           # a train step's: the MoE's aux loss is this rank's share of the blocks' mean

    def __post_init__(self):
        for path, spec in self.pspecs.items():
            for _, axes in self._fsdp_dims(spec):
                if not set(axes) <= set(self.batch_axes):
                    raise ValueError(f"{path}: FSDP axes {axes} of {spec} are not among the batch axes "
                                     f"{self.batch_axes}")

    @property
    def tp(self) -> Optional[str]:
        """The tensor-parallel axis, ``None`` where ``model`` is absent or 1."""
        return "model" if self.mesh.shape.get("model", 1) > 1 else None

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp] if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.index(self.tp) if self.tp else 0

    @property
    def batch_axes(self) -> tuple:
        """The mesh axes the batch rows are split over, major to minor."""
        entry = logical_to_pspec(("batch",), self.rules, self.mesh)
        return tuple(a for a in _entry_axes(entry[0] if entry else None) if self.mesh.shape[a] > 1)

    @property
    def batch_size(self) -> int:
        """How many blocks the rows are split into: 1 for a replicated
        batch."""
        return 1 if self.replicated_batch else math.prod(self.mesh.shape[a] for a in self.batch_axes)

    def _fsdp_dims(self, spec) -> list:
        out = []
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in _entry_axes(entry) if a != "model" and self.mesh.shape[a] > 1)
            if axes:
                out.append((dim, axes))
        return out

    def _reduction(self, spec) -> tuple:
        """(the FSDP dims of ``spec``, the batch axes none of them covers):
        a gradient is summed over the latter and scattered over the
        former."""
        dims = self._fsdp_dims(spec)
        covered = {a for _, axes in dims for a in axes}
        return dims, [a for a in self.batch_axes if a not in covered]

    def _spec(self, path: str, stacked: bool):
        spec = self.pspecs[path]
        return PartitionSpec(*spec[1:]) if stacked else spec

    def fetch(self, tree: dict, prefix: str, stacked: bool = False) -> dict:
        """The leaves of ``tree`` (under ``prefix`` in the parameter tree; a
        layer's slice of the stacked periods when ``stacked``) gathered over
        their FSDP axes, their gradients summed over the batch axes; as
        they are where the step gathered them once."""
        if self.gathered:
            return tree
        out = []
        for key, t in paths(tree).items():
            dims, rest = self._reduction(self._spec(f"{prefix}/{key}" if prefix else key, stacked))
            t = ranks.grad_psum(t, rest, self.mesh, tag="gradient reduce")
            for dim, axes in dims:
                t = ranks.gather(t, axes, dim, self.mesh, tags=("weight gather", "gradient reduce"))
            out.append(t)
        return unflatten_like(tree, out)

    def gather_all(self, params: dict) -> dict:
        """Every block gathered over its FSDP axes (no autograd)."""
        out = []
        for key, t in paths(params).items():
            for dim, axes in self._fsdp_dims(self.pspecs[key]):
                t = ranks.all_gather(t, axes, dim, self.mesh, tag="weight gather")
            out.append(t)
        return unflatten_like(params, out)

    def reduce_all(self, grads: dict) -> dict:
        """Gradients of gathered leaves ({path: tensor}) summed over the
        batch axes, each rank keeping its block."""
        out = {}
        for key, g in grads.items():
            dims, rest = self._reduction(self.pspecs[key])
            g = ranks.psum(g, rest, self.mesh, tag="gradient reduce")
            for dim, axes in dims:
                g = ranks.psum_scatter(g, axes, dim, self.mesh, tag="gradient reduce")
            out[key] = g
        return out

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region: identity, the gradient summed over
        ``tp``."""
        return ranks.grad_psum(x, self.tp, self.mesh, tag="tensor parallel") if self.tp else x

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """Out of a tensor-parallel region: the ranks' parts summed over
        ``tp``."""
        return ranks.value_psum(x, self.tp, self.mesh, tag="tensor parallel") if self.tp else x

    def check(self, x: torch.Tensor, axes: Sequence[Logical], shape: Sequence[int]) -> torch.Tensor:
        """:func:`constrain` on this layout's mesh and rules."""
        return constrain(x, axes, shape, self.mesh, self.rules)

    def seq_axes(self, logical: str, shape: Sequence[int]) -> tuple:
        """The live mesh axes the sequence of a cache block of the global
        ``shape`` (batch, sequence, ...) is split over under ``logical``
        (``cache_seq`` or ``long_cache_seq``): the rule's axes that are
        left after the batch took its own and that divide the sequence."""
        spec = logical_to_pspec(("cache_batch", logical), self.rules, self.mesh, tuple(shape[:2]))
        entry = spec[1] if len(spec) > 1 else None
        return tuple(a for a in _entry_axes(entry) if self.mesh.shape[a] > 1)

    def sharded_axes(self, path: str) -> tuple:
        """The live mesh axes a stored leaf is split over."""
        return tuple(a for entry in self.pspecs[path] for a in _entry_axes(entry) if self.mesh.shape[a] > 1)
