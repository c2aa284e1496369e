"""Mixture-of-Experts FFN (port of ``repro.models.moe``).

One semantics: top-k routing with renormalized weights.  Three execution
paths:

* :func:`moe_reference` is the reference's dropless dense oracle: every
  expert on every token, combined by the routing weights.
* :func:`moe_block` with no mesh, or a one-device mesh, is the dropless
  grouped dispatch the model runs: the (token, slot) pairs sorted by
  expert, one SwiGLU product per expert that holds tokens, on those tokens
  only, and the combine in fp32 with the routing weights — the oracle's
  function (the reference runs the oracle itself there).  A decode step of
  qwen3-moe at batch 2 touches at most 16 of its 128 experts, and reads
  only those experts' weights.
* :func:`moe_block` on a mesh of ranks (:mod:`repro_torch.distributed.ranks`)
  runs the reference's two ``shard_map`` bodies, SPMD: every rank passes
  its own blocks of ``x`` and the weights (as :func:`moe_pspecs` lays them
  out) and gets its block of the output.

  - **EP** (:func:`_moe_ep_body`, ``E % tp == 0``): tokens sharded over
    (pod, data) × model; per-rank capacity buffers; an all-to-all over the
    model axis routes slots to the experts' owners; the expert weights are
    all-gathered over (pod, data) (FSDP); the inverse all-to-all; the local
    combine.
  - **f-TP** (:func:`_moe_ftp_body`, fewer experts than the model axis,
    e.g. mixtral's 8): experts replicated over model, ``d_ff`` sharded,
    the partial products summed over model; tokens stay sharded over
    (pod, data).

  Every collective of both bodies is one autograd differentiates
  (``distributed/ranks.py``: ``exchange``, ``value_psum``, ``grad_psum``,
  ``gather``), so the train step runs them too (:func:`_moe_local`), with
  the aux loss each rank's share of the blocks' mean (:func:`_aux_share`).

  Both keep GShard's capacity: :func:`_capacity` slots an expert a rank,
  :func:`_dispatch_indices` ranks each slot by a stable sort, so earlier
  tokens win, and a slot past the capacity is dropped (its share of the
  output is 0).  :func:`moe_capacity_reference` is their plain version on
  one device: each rank's tokens routed and dropped as the bodies do.  With
  a capacity factor that drops nothing the bodies compute the oracle's
  function.

The products are plain ``torch.matmul``/``einsum``: the reference computes
them with ``einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.models.common import Spec

#: model-axis width of the production meshes (16×16 and 2×16×16); experts
#: shard over the model axis (EP) when divisible, else d_ff shards (f-TP).
EP_MODEL_AXIS = 16


def uses_ep(cfg: ArchConfig) -> bool:
    return cfg.num_experts % EP_MODEL_AXIS == 0


def moe_specs(cfg: ArchConfig) -> dict:
    """The reference's leaves, shapes and storage: router (d, E), expert
    stacks (E, d, f) and (E, f, d), E over ``model`` where the experts go
    expert-parallel (:func:`uses_ep`), else ``d_ff`` over it."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    if uses_ep(cfg):
        return {
            "router": Spec((d, e), ("embed", None), scale=0.02),
            "w_gate": Spec((e, d, f), ("expert", "expert_in", None)),
            "w_up": Spec((e, d, f), ("expert", "expert_in", None)),
            "w_down": Spec((e, f, d), ("expert", None, "expert_in")),
        }
    return {
        "router": Spec((d, e), ("embed", None), scale=0.02),
        "w_gate": Spec((e, d, f), (None, "expert_in", "mlp")),
        "w_up": Spec((e, d, f), (None, "expert_in", "mlp")),
        "w_down": Spec((e, f, d), (None, "mlp", "expert_in")),
    }


def route(
    xt: torch.Tensor, router: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  xt (T, d) → weights (T, k) fp32 (renormalized),
    ids (T, k) int64, plus the Switch aux load-balance loss."""
    logits = xt.float() @ router.float()                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # Switch-style aux loss: E · Σ_e f_e · p_e
    e = router.shape[-1]
    me = torch.mean(probs, dim=0)                                    # (E,)
    ce = torch.mean(F.one_hot(ids, e).float().sum(dim=1), dim=0)
    aux = e * torch.sum(me * ce)
    return w, ids, aux


def moe_reference(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The dropless dense oracle: every expert on every token.  x (B, S, d)
    → (y, aux)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    w, ids, aux = route(xt, params["router"], cfg.experts_per_token)
    h = F.silu(torch.einsum("td,edf->etf", xt, params["w_gate"])) * torch.einsum(
        "td,edf->etf", xt, params["w_up"]
    )
    ye = torch.einsum("etf,efd->etd", h, params["w_down"])           # (E, T, d)
    sel = torch.gather(ye.transpose(0, 1), 1, ids[..., None].expand(-1, -1, d))   # (T, k, d)
    y = torch.einsum("tk,tkd->td", w, sel.float())
    return y.reshape(b, s, d).to(x.dtype), aux


def _capacity(tokens: int, num_experts: int, k: int, cf: float) -> int:
    """Slots an expert holds on one rank: ``ceil(T·k·cf / E)``, padded up
    to a multiple of 8, at least 8."""
    c = int(math.ceil(tokens * k * cf / num_experts))
    return max(8, ((c + 7) // 8) * 8)


def _dispatch_indices(ids: torch.Tensor, num_experts: int, capacity: int):
    """Per-slot expert rank with capacity dropping.

    ids (T, k) → flat expert ids (T·k,), ranks (T·k,) where rank ≥ capacity
    means dropped.  A stable sort ⇒ earlier tokens win slots (GShard
    semantics)."""
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    start = torch.searchsorted(sorted_e, torch.arange(num_experts, device=ids.device, dtype=flat.dtype))
    rank_sorted = torch.arange(flat.numel(), device=ids.device) - start[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return flat, rank


def _expert_ffn(xe: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(E, C, d) × (E, d, f) → (E, C, d), SwiGLU."""
    return torch.bmm(F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu), wd)


def _dispatch(xt, ids, e: int, cap: int):
    """The capacity buffers (E, C, d) of one rank's tokens, and how to read
    the slots back: (flat ids, ranks clipped to C, kept mask)."""
    d = xt.shape[-1]
    k = ids.shape[-1]
    flat, rank = _dispatch_indices(ids, e, cap)
    keep = rank < cap
    rank_c = torch.where(keep, rank, cap)                              # cap ⇒ drop
    xbuf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=xt.device)
    xbuf[flat, rank_c] = xt.repeat_interleave(k, dim=0)                # column cap is the bin
    return xbuf[:, :cap].contiguous(), flat, rank_c % cap, keep


def _combine(ybuf, w, flat, slot, keep, t: int, k: int, dtype):
    """Each kept slot's expert output, weighted and summed in fp32."""
    d = ybuf.shape[-1]
    got = torch.where(keep[:, None], ybuf[flat, slot], 0)
    return torch.einsum("tk,tkd->td", w, got.reshape(t, k, d).float()).to(dtype)


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _branch(cfg: ArchConfig, mesh) -> str:
    """``"ep"`` or ``"ftp"`` on ``mesh``; raises when neither applies."""
    tp = _tp_axis(mesh)
    tp_size = mesh.shape[tp] if tp else 1
    if tp and uses_ep(cfg) and cfg.num_experts % tp_size == 0:
        return "ep"
    if tp and cfg.d_ff % tp_size == 0:
        return "ftp"
    raise ValueError(f"{cfg.name}: no MoE sharding for E={cfg.num_experts} on model={tp_size}")


def moe_pspecs(cfg: ArchConfig, mesh, x_shape) -> dict:
    """The blocks :func:`moe_block` takes on ``mesh``, as the reference's
    ``shard_map`` in_specs: ``x`` (B, S, d) over (pod, data) on the batch
    when it divides, and for EP over model on the sequence when it divides;
    the router replicated; EP's expert stacks E over model and d over
    (pod, data), f-TP's d over (pod, data) and f over model."""
    b, s, _ = x_shape
    dp, tp = _dp_axes(mesh), _tp_axis(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp) if dp else 1
    ep = _branch(cfg, mesh) == "ep"
    batch_shard = dp if (dp and b % dp_size == 0) else None
    seq_shard = tp if (ep and s % mesh.shape[tp] == 0) else None
    x_spec = P(batch_shard, seq_shard, None)
    fs = dp if dp else None
    if ep:
        w_spec, wd_spec = P(tp, fs, None), P(tp, None, fs)
    else:
        w_spec, wd_spec = P(None, fs, tp), P(None, tp, fs)
    return {"x": x_spec, "router": P(), "w_gate": w_spec, "w_up": w_spec, "w_down": wd_spec}


def moe_block(
    params: dict,
    x: torch.Tensor,
    cfg: ArchConfig,
    capacity_factor: Optional[float] = None,
    layout=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN.  x (B, S, d) → (y, aux).

    With no mesh or a one-device mesh: the dropless grouped dispatch,
    :func:`moe_reference`'s function (``capacity_factor`` is not read, as
    the reference's oracle reads none).  It reads the per-expert token
    counts on the host (one synchronization a layer) to size each expert's
    product.

    On a mesh of ranks (installed by ``use_sharding``): the EP or f-TP body
    with GShard capacity ``capacity_factor`` (default the config's), every
    rank passing its blocks of ``x`` and ``params`` as :func:`moe_pspecs`
    lays them out and getting its block of ``y``; the aux loss is the mean
    of the token blocks' over the mesh, as the reference's bodies take it.

    With a ``layout`` (``models/decoder.py``; a serving or a train step's):
    the same bodies on the expert weights as the layout fetched them
    (gathered over their FSDP axes already, so the bodies gather nothing),
    ``x`` this rank's rows (whole over ``model``; the EP body takes its
    block of the sequence where ``model`` divides it, as :func:`moe_pspecs`
    places it, and the blocks of ``y`` are gathered back over ``model``),
    differentiable (:func:`_moe_local`).  A serving step's aux loss is this
    rank's block's own (serving discards it); a train step's is this
    rank's share of the mean of the blocks' (:func:`_aux_share`)."""
    if layout is not None:
        return _moe_local(params, x, cfg, capacity_factor, layout)
    mesh = shd.current_mesh()
    if mesh is not None and mesh.size > 1:
        cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
        dp, tp = _dp_axes(mesh), _tp_axis(mesh)
        ep = _branch(cfg, mesh) == "ep"
        body = _moe_ep_body if ep else _moe_ftp_body
        y, aux = body(x, params["router"], params["w_gate"], params["w_up"], params["w_down"],
                      cfg=cfg, cf=cf, dp=dp, tp=tp, mesh=mesh)
        axes = ((tp,) if ep else ()) + dp
        return y, ranks.pmean(aux, axes, mesh) if axes else aux
    b, s, d = x.shape
    k = cfg.experts_per_token
    xt = x.reshape(-1, d)
    w, ids, aux = route(xt, params["router"], k)
    flat = ids.reshape(-1)                                           # (T·k,) slot → expert
    order = torch.argsort(flat, stable=True)                         # slots grouped by expert
    counts = torch.bincount(flat, minlength=cfg.num_experts).tolist()
    tokens = order // k                                              # each sorted slot's token
    slots = torch.empty((flat.numel(), d), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        rows = order[start:start + n]
        xe = xt[tokens[start:start + n]]
        h = F.silu(xe @ params["w_gate"][e]) * (xe @ params["w_up"][e])
        slots[rows] = h @ params["w_down"][e]
        start += n
    y = torch.einsum("tk,tkd->td", w, slots.reshape(-1, k, d).float())
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_local(params, x, cfg: ArchConfig, capacity_factor, layout):
    """:func:`moe_block` on a ``layout``, every collective one autograd
    differentiates.  EP: ``x`` (replicated over ``model``) enters through
    ``grad_psum`` before each rank takes its block of the sequence, and so
    does the router, whose blocks of tokens differ by rank; the slots go
    to the experts' owners and back by ``ranks.exchange``; ``y``'s blocks
    are gathered over ``model`` (each rank's gradient of the whole ``y`` is
    the same, so the backward keeps its block unsummed).  f-TP: the
    routing runs alike on every rank of ``model``, the expert products on
    its columns of ``d_ff``, their parts summed by ``value_psum`` and the
    dispatched tokens entered through ``grad_psum`` (Megatron's pair)."""
    mesh = layout.mesh
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    tp = _tp_axis(mesh)
    n = mesh.shape[tp] if tp else 1
    e, f = cfg.num_experts, cfg.d_ff
    router, wg, wu, wd = params["router"], params["w_gate"], params["w_up"], params["w_down"]
    args = dict(cfg=cfg, cf=cf, dp=(), tp=tp, mesh=mesh)
    if _branch(cfg, mesh) == "ep":
        if wg.shape[0] * n != e or wg.shape[2] != f:
            raise ValueError(f"{cfg.name}: the expert-parallel body takes E / {n} whole experts a rank, got a "
                             f"{tuple(wg.shape)} block")
        s = x.shape[1]
        if s % n:
            if layout.training:
                raise ValueError(f"{cfg.name}: the expert-parallel body trains on its block of the sequence; "
                                 f"{s} positions do not split over model {n}")
            return _moe_ep_body(x, router, wg, wu, wd, **args)
        xs = layout.enter(x).chunk(n, 1)[mesh.index(tp)]
        y, aux = _moe_ep_body(xs, layout.enter(router), wg, wu, wd, **args)
        y = ranks.gather(y, tp, 1, mesh, tags=("expert parallel",) * 2, reduce=False)
        return y, _aux_share(aux, (tp,), layout.batch_size * n, layout)
    if wg.shape[0] != e or wg.shape[2] * n != f:
        raise ValueError(f"{cfg.name}: the f-sharded body takes every expert with d_ff / {n} a rank, got a "
                         f"{tuple(wg.shape)} block")
    y, aux = _moe_ftp_body(x, router, wg, wu, wd, **args)
    return y, _aux_share(aux, (), layout.batch_size, layout)


def _aux_share(aux: torch.Tensor, split: tuple, blocks: int, layout) -> torch.Tensor:
    """A train step's aux term of this rank: the sum of its token blocks'
    aux over the axes of ``split`` (the ranks of one row block that route
    blocks of its tokens) over the mesh's count of ``blocks``, so that the
    ranks' terms add up over the batch axes to the mean of the blocks' aux
    (the reference's ``pmean`` over (model, pod, data) of each block's
    aux, ``src/repro/models/moe.py:240-243``), and each block's gradient is
    its aux's over ``blocks``.  A serving step's is its block's own aux."""
    if not layout.training:
        return aux
    return ranks.value_psum(aux, split, layout.mesh, tag="expert parallel") / blocks if split else aux / blocks


def _gather_fsdp(w: torch.Tensor, dp: tuple, dim: int, mesh) -> torch.Tensor:
    return ranks.gather(w, dp, dim, mesh, tags=("all_gather", "psum_scatter")) if dp else w


def _moe_ep_body(x, router, wg, wu, wd, *, cfg, cf, dp, tp, mesh):
    """Expert-parallel body (E % tp == 0).  Local shapes:
    x (B_l, S_l, d); wg/wu (E_l, d_l, f); wd (E_l, f, d_l).  → (this
    rank's block of y, its block's aux)."""
    bl, sl, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    t = bl * sl
    xt = x.reshape(t, d)
    w, ids, aux = route(xt, router, k)
    cap = _capacity(t, e, k, cf)
    xbuf, flat, slot, keep = _dispatch(xt, ids, e, cap)
    # route slots to expert owners over the model axis: split the expert dim
    # (tp blocks of E_l), receive tp slot-blocks concatenated on the slot dim
    xe = ranks.exchange(xbuf, tp, 0, 1, mesh)                          # (E_l, tp·cap, d)
    ye = _expert_ffn(xe, _gather_fsdp(wg, dp, 1, mesh), _gather_fsdp(wu, dp, 1, mesh),
                     _gather_fsdp(wd, dp, 2, mesh))
    # return slots to their source columns (the inverse exchange)
    yb = ranks.exchange(ye, tp, 1, 0, mesh)                            # (E, cap, d)
    y = _combine(yb, w, flat, slot, keep, t, k, x.dtype)
    return y.reshape(bl, sl, d), aux


def _moe_ftp_body(x, router, wg, wu, wd, *, cfg, cf, dp, tp, mesh):
    """f-sharded tensor-parallel body (E < tp; experts replicated on model,
    d_ff sharded, summed over model).  Local: x (B_l, S, d) — tokens are
    not sharded over model here; wg/wu (E, d_l, f_l); wd (E, f_l, d_l).
    → (this rank's block of y, its block's aux)."""
    bl, sl, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    t = bl * sl
    xt = x.reshape(t, d)
    w, ids, aux = route(xt, router, k)
    cap = _capacity(t, e, k, cf)
    # the routing is alike on every rank of model; the products' input enters the f-split region
    xbuf, flat, slot, keep = _dispatch(ranks.grad_psum(xt, tp, mesh, tag="tensor parallel"), ids, e, cap)
    ye = _expert_ffn(xbuf, _gather_fsdp(wg, dp, 1, mesh), _gather_fsdp(wu, dp, 1, mesh),
                     _gather_fsdp(wd, dp, 2, mesh))                    # partial over f
    ye = ranks.value_psum(ye, tp, mesh)
    y = _combine(ye, w, flat, slot, keep, t, k, x.dtype)
    return y.reshape(bl, sl, d), aux


def moe_capacity_reference(
    params: dict, x: torch.Tensor, cfg: ArchConfig, capacity_factor: float, mesh_shape: dict
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The plain version of the sharded bodies on one device, with the
    whole weights: ``x`` is cut into the token blocks the bodies see on a
    mesh of ``mesh_shape`` (axis → size, e.g. ``{"data": 2, "model": 2}``),
    each block routed, given :func:`_capacity` slots an expert and dropped
    by :func:`_dispatch_indices`, its kept slots run through every expert's
    whole FFN and combined.  Returns (y, aux: the mean of the blocks',
    dropped slots), differentiable.  Tests and ``chip_smoke.py`` hold the
    bodies to it; nothing on the model's path calls it."""
    mesh = shd.Mesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    spec = moe_pspecs(cfg, mesh, x.shape)["x"]
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    nb = math.prod(mesh.shape[a] for a in spec[0]) if spec[0] else 1
    ns = mesh.shape[spec[1]] if spec[1] else 1
    rows, auxes, dropped = [], [], 0
    for xb in x.chunk(nb, 0):
        cols = []
        for xs in xb.chunk(ns, 1):
            t = xs.shape[0] * xs.shape[1]
            xt = xs.reshape(t, d)
            w, ids, aux = route(xt, params["router"], k)
            cap = _capacity(t, e, k, capacity_factor)
            xbuf, flat, slot, keep = _dispatch(xt, ids, e, cap)
            ybuf = _expert_ffn(xbuf, params["w_gate"], params["w_up"], params["w_down"])
            cols.append(_combine(ybuf, w, flat, slot, keep, t, k, x.dtype).reshape(xs.shape))
            auxes.append(aux)
            dropped += int((~keep).sum())
        rows.append(torch.cat(cols, 1))
    return torch.cat(rows, 0), torch.stack(auxes).mean(), dropped
