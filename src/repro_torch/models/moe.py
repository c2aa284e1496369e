"""Mixture-of-Experts FFN on one device (port of the single-device part of
``repro.models.moe``).

One semantics, the reference's on one device: top-k routing with
renormalized weights and no capacity, so no token is dropped.

* :func:`moe_reference` is the reference's dropless dense oracle: every
  expert on every token, combined by the routing weights.  The tests hold
  :func:`moe_block` to it.
* :func:`moe_block` is the dropless grouped dispatch the model runs: the
  (token, slot) pairs sorted by expert, one SwiGLU product per expert that
  holds tokens, on those tokens only, and the combine in fp32 with the
  routing weights.  A decode step of qwen3-moe at batch 2 touches at most
  16 of its 128 experts, and reads only those experts' weights.

The products are plain ``torch.matmul``: the reference computes them with
``einsum`` outside any Pallas kernel.  The reference's sharded paths
(capacity, dispatch indices, the expert-parallel and f-sharded bodies) are
not ported: on one card they have nothing to shard.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Spec


def moe_specs(cfg: ArchConfig) -> dict:
    """The reference's leaves and shapes: router (d, E), expert stacks
    (E, d, f) and (E, f, d)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": Spec((d, e), ("embed", None), scale=0.02),
        "w_gate": Spec((e, d, f), ("expert", "expert_in", "mlp")),
        "w_up": Spec((e, d, f), ("expert", "expert_in", "mlp")),
        "w_down": Spec((e, f, d), ("expert", "mlp", "expert_in")),
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


def moe_block(params: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless grouped dispatch, :func:`moe_reference`'s function.
    x (B, S, d) → (y, aux).  Reads the per-expert token counts on the host
    (one synchronization a layer) to size each expert's product."""
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
