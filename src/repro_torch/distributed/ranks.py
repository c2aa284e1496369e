"""The multi-rank runtime: the port's stand-in for XLA's multi-device
runtime.

The reference gets its devices from XLA and runs one SPMD program over them
(``shard_map``).  Torch needs processes: :func:`spawn` starts ``n`` ranks
(``torch.multiprocessing``, start method ``forkserver``: see
:func:`process_context`), joins them into one gloo process group, runs the same function in each and returns rank 0's
result.  Inside a rank, :func:`make_mesh` builds a
:class:`~repro_torch.distributed.sharding.Mesh` backed by a
``torch.distributed.device_mesh.DeviceMesh`` (one process group a named
axis), and :func:`psum`, :func:`pmean`, :func:`all_gather` and
:func:`all_to_all` are the reference's ``lax`` collectives over one named
mesh axis (or several, major to minor), and :func:`psum_scatter` is
``lax.psum_scatter``.

**Autograd.**  The collectives above move values only.  A train step on
local blocks needs four that autograd differentiates, each the transpose
of the other's forward: :func:`grad_psum` (identity forward, ``psum`` of
the gradient backward: where a replicated tensor enters a region whose
ranks each add a part of its gradient), :func:`value_psum` (``psum``
forward, identity backward: where the ranks' parts of a value are summed
into one that every rank then uses alike), :func:`gather` (an
all-gather forward, :func:`psum_scatter` of the gradient backward: FSDP's
weight gather) and :func:`exchange` (an all-to-all forward, the inverse
all-to-all of the gradient backward: the MoE's expert-parallel
dispatch).  Under ``torch.utils.checkpoint`` the recomputed forward runs
them again, in the same order on every rank.

**Backend.**  Gloo, with a ``FileStore`` rendezvous in a fresh temporary
directory (never a fixed port, so two spawns at once do not collide) and a
timeout on the group and on the join.  Gloo has no ``all_to_all`` on CUDA
tensors, so on the card every collective copies its operand to pinned host
memory, runs there and copies the result back — the four collectives below
are the only place it happens — and :data:`RUNTIME` is what a mesh's report
says (``backend: "gloo", staged: "host"``).  Gloo has no reduce-scatter,
so :func:`psum_scatter` is a :func:`psum` of the whole tensor followed by
this rank's block: it moves the whole tensor where a reduce-scatter would
move a block, and :data:`stats` counts those bytes.  NCCL, one rank a card, waits
for a machine with as many cards as ranks.

**Devices.**  Each rank computes on the caller's device: ``cuda:(rank mod
cards)`` — ``cuda:0`` for every rank on a one-card machine — or the CPU
when asked.  A throughput measured with several ranks on one card measures
this runtime and its host-staged collectives, not scale-out.

**Traffic.**  While :data:`stats` is a dict, each staged collective
synchronizes the device first (so its time is its own) and adds to
``stats[tag]`` its calls, the bytes it stages (the operand to the host and
the result back) and its seconds; ``tag`` names what the caller moves
("weight gather", "gradient reduce", "tensor parallel", ...).

**Dry mode.**  On ``meta`` tensors every collective creates no process
group and moves nothing: it returns a ``meta`` tensor of the result's shape
and counts as the live one would, so a rank's step can be run on ``meta``
on a descriptor mesh (``sharding.Mesh`` with this rank's ``coordinate``)
to count its traffic (``launch/roofline.py``).  :data:`stats` takes the
same calls and bytes under the same tags as a live run's (and no seconds);
:data:`traffic` takes, live or dry, the reference's ring model of each
collective (``repro.launch.roofline._ring_factor``) by kind over its
group's size.

**Failures.**  A rank that raises sends its traceback; :func:`spawn` then
tears the other ranks down and raises :class:`RankError` with it.  A rank
that dies without a word (killed, out of memory) or a run past
``timeout_s`` raises too.  Nothing is caught and passed over.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

__all__ = [
    "RUNTIME",
    "RankError",
    "all_gather",
    "all_to_all",
    "barrier",
    "device",
    "exchange",
    "gather",
    "grad_psum",
    "info",
    "make_mesh",
    "pmean",
    "process_context",
    "psum",
    "psum_scatter",
    "rank",
    "shard",
    "spawn",
    "stats",
    "unshard",
    "value_psum",
    "world_size",
]

#: What every report of a mesh says about the runtime under it.
RUNTIME = {"backend": "gloo", "staged": "host"}

Axes = Union[str, Sequence[str]]

#: per tag: {"calls", "bytes", "s"} of the staged collectives while a dict
#: (see the module docstring); None counts nothing
stats: Optional[dict] = None

#: per kind ("all-reduce", "all-gather", "all-to-all"): {"bytes", "count"}
#: of the reference's ring model of each collective while a dict; None
#: counts nothing
traffic: Optional[dict] = None


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback."""


# ---------------------------------------------------------------------------
# Spawning
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _RankState:
    rank: int = 0
    world: int = 1
    device: Optional[torch.device] = None
    spawn_s: Optional[float] = None
    cards: int = 0
    meshes: dict = dataclasses.field(default_factory=dict)


_state: Optional[_RankState] = None


def rank() -> int:
    return _state.rank if _state is not None else 0


def world_size() -> int:
    return _state.world if _state is not None else 1


def device() -> torch.device:
    """This rank's device (raises outside :func:`spawn`)."""
    if _state is None:
        raise RuntimeError("repro_torch.distributed.ranks.device() is only defined inside spawn()")
    return _state.device


def info() -> dict:
    """The runtime under this rank's meshes: ranks, backend, staging, how
    many ranks share a card and the seconds from :func:`spawn`'s call to
    this rank's group being up."""
    if _state is None:
        return {"ranks": 1, **RUNTIME, "ranks_per_card": None, "spawn_s": 0.0}
    per_card = -(-_state.world // _state.cards) if _state.cards else None
    return {"ranks": _state.world, **RUNTIME, "ranks_per_card": per_card, "spawn_s": _state.spawn_s}


def _to_host(obj: Any) -> Any:
    """Rank 0's result with every tensor on the CPU, so it pickles without
    the card."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to_host(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _entry(r, n, store_path, dev_type, threads, timeout_s, t0, fn, args, kwargs, results):
    global _state
    import torch.distributed as dist

    try:
        torch.set_num_threads(threads)
        cards = torch.cuda.device_count() if dev_type == "cuda" else 0
        if dev_type == "cuda":
            dev = torch.device("cuda", r % cards)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        _state = _RankState(rank=r, world=n, device=dev, cards=cards)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, n), rank=r, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        _state.spawn_s = time.time() - t0
        out = fn(*args, **kwargs)
        results.put((r, True, pickle.dumps(_to_host(out)) if r == 0 else None))
    except BaseException:
        results.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def process_context():
    """The start method of the ranks: ``forkserver``, whose server imports
    torch once, so that each rank is forked from it instead of importing
    torch itself, which on a card host takes seconds a process.  The server
    never starts CUDA; each rank starts its own.  It holds the environment
    of the moment it started, and ends with this process."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    return ctx


def spawn(
    n: int,
    fn: Callable,
    *args,
    device: Union[str, torch.device] = "cuda",
    timeout_s: float = 900.0,
    **kwargs,
) -> Any:
    """Run ``fn(*args, **kwargs)`` in ``n`` ranks and return rank 0's result.

    ``fn`` must be importable by name (a module-level function), and its
    arguments picklable.  Each rank computes on ``device`` (see the module
    docstring); ``"cuda"`` raises before any process starts on a host with
    no card.  ``timeout_s`` bounds the process group's collectives and the
    whole join.  The host's cores are shared among the ranks' torch
    threads.
    """
    if n < 1:
        raise ValueError(f"spawn needs at least one rank, got {n}")
    dev = resolve_device(device)
    threads = max(1, (os.cpu_count() or 1) // n)
    ctx = process_context()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    t0 = time.time()
    procs = [
        ctx.Process(
            target=_entry, daemon=True,
            args=(r, n, os.path.join(tmp, "store"), dev.type, threads, timeout_s, t0,
                  fn, args, kwargs, results),
        )
        for r in range(n)
    ]
    deadline = time.monotonic() + timeout_s
    pending, out = set(range(n)), None
    try:
        for p in procs:
            p.start()
        while pending:
            try:
                r, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                for r in sorted(pending):
                    code = procs[r].exitcode
                    if code not in (None, 0):
                        raise RankError(f"rank {r} of {n} died with exit code {code} before reporting")
                if time.monotonic() > deadline:
                    raise RankError(f"ranks {sorted(pending)} of {n} did not finish within {timeout_s} s")
                continue
            if not ok:
                # a peer that died first (its socket closed) is the cause
                time.sleep(0.5)
                dead = "".join(f"\nrank {k} of {n} died with exit code {procs[k].exitcode} before reporting"
                               for k in sorted(pending - {r}) if procs[k].exitcode not in (None, 0))
                raise RankError(f"rank {r} of {n} failed:\n{payload}{dead}")
            pending.discard(r)
            if r == 0:
                out = pickle.loads(payload)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------
def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]):
    """A :class:`~repro_torch.distributed.sharding.Mesh` over the first
    ``prod(axis_sizes)`` ranks, row-major, on this rank's device, backed by
    a ``DeviceMesh`` with one process group a named axis.

    Every rank of the spawn must call it (creating a group is collective);
    a rank outside the mesh gets a mesh whose ``coordinate`` is ``None``.
    Meshes are kept per rank by shape, so asking twice builds no new
    groups.  A one-device mesh needs no spawn; a larger one raises outside
    :func:`spawn`, naming the fix."""
    from repro_torch.distributed.sharding import Mesh

    sizes, names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axis sizes must be >= 1, got {dict(zip(names, sizes))}")
    need = 1
    for s in sizes:
        need *= s
    if need == 1:
        dev = _state.device if _state is not None else None
        return Mesh(sizes, names, device=dev, coordinate=(0,) * len(sizes))
    if need > world_size():
        raise ValueError(
            f"a {'x'.join(map(str, sizes))} mesh needs {need} ranks but {world_size()} "
            f"{'is' if world_size() == 1 else 'are'} running: run the program in "
            f"repro_torch.distributed.ranks.spawn({need}, fn, ...) (or a CLI's --mesh)"
        )
    key = (sizes, names)
    if key not in _state.meshes:
        from torch.distributed.device_mesh import DeviceMesh

        dm = DeviceMesh("cpu", torch.arange(need).reshape(sizes), mesh_dim_names=names)
        coord = dm.get_coordinate()
        _state.meshes[key] = Mesh(sizes, names, device=_state.device, device_mesh=dm,
                                  coordinate=tuple(coord) if coord is not None else None)
    return _state.meshes[key]


# ---------------------------------------------------------------------------
# Collectives over named mesh axes, staged through host memory
# ---------------------------------------------------------------------------
def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _mesh(mesh):
    if mesh is None:
        from repro_torch.distributed.sharding import current_mesh

        mesh = current_mesh()
    if mesh is None:
        raise ValueError("a collective needs a mesh: pass mesh= or install one with use_sharding")
    return mesh


def _group(mesh, axis: str):
    if mesh.device_mesh is None:
        raise ValueError(f"axis {axis!r} of a {mesh.shape} mesh has no process group: build it with make_mesh")
    return mesh.device_mesh.get_group(axis)


_BYTES = (torch.bfloat16, torch.float16, torch.bool)


def _host(x: torch.Tensor) -> torch.Tensor:
    """The operand as gloo takes it: contiguous, in host memory (pinned when
    it comes from the card); 16-bit floats and bools travel as their bytes
    (the last dimension's bytes) in the collectives that only move data."""
    x = x.contiguous()
    if x.dtype in _BYTES:
        x = x.view(torch.uint8)
    if x.device.type == "cpu":
        return x
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _back(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A result staged on the host → ``like``'s device and dtype."""
    if h.dtype != like.dtype:
        h = h.view(like.dtype)
    return h.to(like.device)


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _ring_factor(kind: str, n: int) -> float:
    """The reference's ring model: bytes moved a member per result byte."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all-reduce" else 1.0) * (n - 1) / n


def _recorded(tag: str, x: torch.Tensor, run: Callable[[], torch.Tensor], ring: Sequence = ()) -> torch.Tensor:
    """``run()``, a staged collective of ``x`` (a ``meta`` result for a
    ``meta`` ``x``), added to :data:`stats` while it is a dict: its
    operand's and result's bytes and its seconds, the device synchronized
    before and after; and to :data:`traffic` while it is a dict, each
    (kind, group size, result bytes) of ``ring`` by the ring model."""
    if traffic is not None:
        for kind, n, nbytes in ring:
            entry = traffic.setdefault(kind, {"bytes": 0.0, "count": 0})
            entry["bytes"] += _ring_factor(kind, n) * nbytes
            entry["count"] += 1
    if stats is None:
        return run()
    _sync(x)
    t0 = time.perf_counter()
    out = run()
    _sync(out)
    entry = stats.setdefault(tag, {"calls": 0, "bytes": 0, "s": 0.0})
    entry["calls"] += 1
    entry["bytes"] += x.numel() * x.element_size() + out.numel() * out.element_size()
    entry["s"] += 0.0 if x.is_meta else time.perf_counter() - t0
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def psum(x: torch.Tensor, axes: Axes, mesh=None, *, tag: str = "psum") -> torch.Tensor:
    """``lax.psum``: the sum over the named axes (16-bit floats are summed
    in fp32 and rounded once)."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    if not _live(axes, mesh):
        return x

    live = _live(axes, mesh)

    def run():
        if x.is_meta:
            return torch.empty_like(x)
        out = x
        for axis in live:
            wide = out.float() if out.dtype in (torch.bfloat16, torch.float16) else out
            h = _host(wide)
            h = h.clone() if h is wide else h
            dist.all_reduce(h, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
            out = _back(h, wide).to(x.dtype)
        return out

    return _recorded(tag, x, run, [("all-reduce", mesh.shape[a], _nbytes(x)) for a in live])


def pmean(x: torch.Tensor, axes: Axes, mesh=None, *, tag: str = "psum") -> torch.Tensor:
    """``lax.pmean``: :func:`psum` divided by the axes' size."""
    mesh = _mesh(mesh)
    n = 1
    for axis in _axes(axes):
        n *= mesh.shape[axis]
    return psum(x, axes, mesh, tag=tag) / n if n > 1 else x


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None, *, tag: str = "all_gather") -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the axis members' blocks
    concatenated along ``dim`` in coordinate order; several axes gather the
    minor axis first, so the blocks come out major to minor."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    if not _live(axes, mesh):
        return x

    steps, size = [], _nbytes(x)
    for axis in reversed(_live(axes, mesh)):
        size *= mesh.shape[axis]
        steps.append(("all-gather", mesh.shape[axis], size))

    def run():
        out = x
        for axis in reversed(_live(axes, mesh)):
            if x.is_meta:
                shape = list(out.shape)
                shape[dim] *= mesh.shape[axis]
                out = out.new_empty(shape)
                continue
            h = _host(out)
            parts = [torch.empty_like(h) for _ in range(mesh.shape[axis])]
            dist.all_gather(parts, h, group=_group(mesh, axis))
            out = _back(torch.cat(parts, dim=dim), out)
        return out

    return _recorded(tag, x, run, steps)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int, mesh=None, *,
               tag: str = "all_to_all") -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)`` over one axis: ``x`` is cut into
    the axis' size blocks along ``split_dim``, block j goes to member j, and
    the blocks received are concatenated along ``concat_dim`` in the
    senders' order."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split {n} ways")

    def run():
        if x.is_meta:
            shape = list(x.shape)
            shape[split_dim] //= n
            shape[concat_dim] *= n
            return x.new_empty(shape)
        send = _host(torch.stack(torch.chunk(x, n, dim=split_dim)))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=_group(mesh, axis))
        return _back(torch.cat(list(recv.unbind(0)), dim=concat_dim), x)

    return _recorded(tag, x, run, [("all-to-all", n, _nbytes(x))])


def _block(t: torch.Tensor, axes: tuple, dim: int, mesh) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``, split over ``axes`` (major
    to minor, as :func:`shard` cuts)."""
    n = math.prod(mesh.shape[a] for a in axes)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({n})")
    return t.chunk(n, dim)[mesh.index(axes)].contiguous()


def psum_scatter(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None, *, tag: str = "psum_scatter") -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over the named axes,
    of which this rank keeps its block along ``dim``.  Gloo has no
    reduce-scatter: this is a :func:`psum` of the whole tensor, then the
    block."""
    mesh = _mesh(mesh)
    axes = _live(axes, mesh)
    return _block(psum(x, axes, mesh, tag=tag), axes, dim, mesh) if axes else x


def barrier(mesh=None) -> None:
    """Wait until every rank of ``mesh`` arrives (a sum over all its axes)."""
    mesh = _mesh(mesh)
    psum(torch.zeros(1, device=mesh.device), mesh.axis_names, mesh, tag="barrier")


# ---------------------------------------------------------------------------
# Collectives that autograd differentiates
# ---------------------------------------------------------------------------
class _GradPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, tag):
        ctx.args = axes, mesh, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes, mesh, tag = ctx.args
        return psum(g, axes, mesh, tag=tag), None, None, None


class _ValuePsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh, tag):
        return psum(x, axes, mesh, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh, tags, reduce):
        ctx.args = axes, dim, mesh, tags[1], reduce
        return all_gather(x, axes, dim, mesh, tag=tags[0])

    @staticmethod
    def backward(ctx, g):
        axes, dim, mesh, tag, reduce = ctx.args
        g = psum_scatter(g, axes, dim, mesh, tag=tag) if reduce else _block(g, axes, dim, mesh)
        return g, None, None, None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, mesh, tag):
        ctx.args = axis, split_dim, concat_dim, mesh, tag
        return all_to_all(x, axis, split_dim, concat_dim, mesh, tag=tag)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim, mesh, tag = ctx.args
        return all_to_all(g, axis, concat_dim, split_dim, mesh, tag=tag), None, None, None, None, None


def _live(axes: Axes, mesh) -> tuple:
    return tuple(a for a in _axes(axes) if mesh.shape[a] > 1)


def grad_psum(x: torch.Tensor, axes: Axes, mesh=None, *, tag: str = "psum") -> torch.Tensor:
    """Identity forward, :func:`psum` of the gradient over ``axes``
    backward (Megatron's *f*)."""
    mesh = _mesh(mesh)
    axes = _live(axes, mesh)
    return _GradPsum.apply(x, axes, mesh, tag) if axes else x


def value_psum(x: torch.Tensor, axes: Axes, mesh=None, *, tag: str = "psum") -> torch.Tensor:
    """:func:`psum` forward, identity backward (Megatron's *g*)."""
    mesh = _mesh(mesh)
    axes = _live(axes, mesh)
    return _ValuePsum.apply(x, axes, mesh, tag) if axes else x


def gather(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None, *,
           tags: tuple = ("all_gather", "psum_scatter"), reduce: bool = True) -> torch.Tensor:
    """:func:`all_gather` forward, :func:`psum_scatter` of the gradient
    backward: the whole tensor from this rank's block, each rank's gradient
    summed back into the blocks.  With ``reduce=False`` the backward keeps
    this rank's block of the gradient unsummed: for a whole tensor that
    every rank of ``axes`` uses alike, whose gradient is the same on each.
    ``tags`` name the forward's and the backward's traffic."""
    mesh = _mesh(mesh)
    axes = _live(axes, mesh)
    return _Gather.apply(x, axes, dim, mesh, tuple(tags), reduce) if axes else x


def exchange(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int, mesh=None, *,
             tag: str = "all_to_all") -> torch.Tensor:
    """:func:`all_to_all` forward; backward, the inverse exchange of the
    gradient (``split_dim`` and ``concat_dim`` swapped, the same axis and
    tag): each block's gradient goes back to the member that sent it."""
    mesh = _mesh(mesh)
    if mesh.shape[axis] == 1:
        return x
    return _Exchange.apply(x, axis, split_dim, concat_dim, mesh, tag)


# ---------------------------------------------------------------------------
# Blocks of a tensor by PartitionSpec
# ---------------------------------------------------------------------------
def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard(t: torch.Tensor, pspec, mesh=None) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``pspec`` (one
    entry a leading dimension: ``None``, an axis or a tuple of axes, major
    to minor) — what ``shard_map`` hands its body."""
    mesh = _mesh(mesh)
    for dim, entry in enumerate(pspec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({n})")
        t = t.chunk(n, dim)[mesh.index(axes)]
    return t


def unshard(t: torch.Tensor, pspec, mesh=None) -> torch.Tensor:
    """The whole tensor from every rank's block under ``pspec`` (the
    inverse of :func:`shard`), on every rank of the mesh."""
    mesh = _mesh(mesh)
    for dim, entry in enumerate(pspec):
        axes = _dim_axes(entry)
        if axes:
            t = all_gather(t, axes, dim, mesh)
    return t
