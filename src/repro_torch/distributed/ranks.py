"""The multi-rank runtime: the port's stand-in for XLA's multi-device
runtime.

The reference gets its devices from XLA and runs one SPMD program over them
(``shard_map``).  Torch needs processes: :func:`spawn` starts ``n`` ranks
(``torch.multiprocessing``, start method ``spawn``), joins them into one
gloo process group, runs the same function in each and returns rank 0's
result.  Inside a rank, :func:`make_mesh` builds a
:class:`~repro_torch.distributed.sharding.Mesh` backed by a
``torch.distributed.device_mesh.DeviceMesh`` (one process group a named
axis), and :func:`psum`, :func:`pmean`, :func:`all_gather` and
:func:`all_to_all` are the reference's ``lax`` collectives over one named
mesh axis (or several, major to minor).

**Backend.**  Gloo, with a ``FileStore`` rendezvous in a fresh temporary
directory (never a fixed port, so two spawns at once do not collide) and a
timeout on the group and on the join.  Gloo has no ``all_to_all`` on CUDA
tensors, so on the card every collective copies its operand to pinned host
memory, runs there and copies the result back — the four collectives below
are the only place it happens — and :data:`RUNTIME` is what a mesh's report
says (``backend: "gloo", staged: "host"``).  NCCL, one rank a card, waits
for a machine with as many cards as ranks.

**Devices.**  Each rank computes on the caller's device: ``cuda:(rank mod
cards)`` — ``cuda:0`` for every rank on a one-card machine — or the CPU
when asked.  A throughput measured with several ranks on one card measures
this runtime and its host-staged collectives, not scale-out.

**Failures.**  A rank that raises sends its traceback; :func:`spawn` then
tears the other ranks down and raises :class:`RankError` with it.  A rank
that dies without a word (killed, out of memory) or a run past
``timeout_s`` raises too.  Nothing is caught and passed over.
"""
from __future__ import annotations

import dataclasses
import datetime
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
    "device",
    "info",
    "make_mesh",
    "pmean",
    "psum",
    "rank",
    "shard",
    "spawn",
    "unshard",
    "world_size",
]

#: What every report of a mesh says about the runtime under it.
RUNTIME = {"backend": "gloo", "staged": "host"}

Axes = Union[str, Sequence[str]]


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
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"spawn needs at least one rank, got {n}")
    dev = resolve_device(device)
    threads = max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
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


def psum(x: torch.Tensor, axes: Axes, mesh=None) -> torch.Tensor:
    """``lax.psum``: the sum over the named axes (16-bit floats are summed
    in fp32 and rounded once)."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    out = x
    for axis in _axes(axes):
        if mesh.shape[axis] == 1:
            continue
        wide = out.float() if out.dtype in (torch.bfloat16, torch.float16) else out
        h = _host(wide)
        h = h.clone() if h is wide else h
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=_group(mesh, axis))
        out = _back(h, wide).to(x.dtype)
    return out


def pmean(x: torch.Tensor, axes: Axes, mesh=None) -> torch.Tensor:
    """``lax.pmean``: :func:`psum` divided by the axes' size."""
    mesh = _mesh(mesh)
    n = 1
    for axis in _axes(axes):
        n *= mesh.shape[axis]
    return psum(x, axes, mesh) / n if n > 1 else x


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the axis members' blocks
    concatenated along ``dim`` in coordinate order; several axes gather the
    minor axis first, so the blocks come out major to minor."""
    import torch.distributed as dist

    mesh = _mesh(mesh)
    out = x
    for axis in reversed(_axes(axes)):
        n = mesh.shape[axis]
        if n == 1:
            continue
        h = _host(out)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=_group(mesh, axis))
        out = _back(torch.cat(parts, dim=dim), out)
    return out


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int, mesh=None) -> torch.Tensor:
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
    send = _host(torch.stack(torch.chunk(x, n, dim=split_dim)))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=_group(mesh, axis))
    return _back(torch.cat(list(recv.unbind(0)), dim=concat_dim), x)


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
