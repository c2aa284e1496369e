"""GQA attention block: qk_norm, RoPE, sliding window, KV cache (port of
``repro.models.attention``: prefill with its cache, decode, and the
cache-free forward the encoder runs).

Cache layout: ``KVCache(k, v, positions, index)`` where ``k``/``v`` are
(B, C, KVH, D) ring/linear buffers, ``positions`` (C,) holds each slot's
absolute position (−1 = uninitialized), and ``index`` is the next absolute
position.  Unlike the reference's immutable arrays, decode writes the new
key and value into the buffers in place (saving a copy of the cache per
step) and returns the same cache with ``index`` advanced.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.models.common import Spec, apply_rope, rms_norm, rope_angles


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, C, KVH, D)
    v: torch.Tensor           # (B, C, KVH, D)
    positions: torch.Tensor   # (C,) int32, absolute positions; -1 invalid
    index: int                # next absolute position


def attention_specs(cfg: ArchConfig) -> dict:
    d, q, kv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    specs = {
        "wq": Spec((d, q), ("embed", "heads")),
        "wk": Spec((d, kv), ("embed", "kv")),
        "wv": Spec((d, kv), ("embed", "kv")),
        "wo": Spec((q, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = Spec((hd,), ("norm",), init="ones")
        specs["k_norm"] = Spec((hd,), ("norm",), init="ones")
    return specs


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"
) -> KVCache:
    """Empty cache on ``device`` (the card by default; raises without one
    unless ``device="cpu"``).  Under SWA the buffer is bounded by the
    window."""
    device = resolve_device(device)
    c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, c, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((c,), -1, dtype=torch.int32, device=device),
        index=0,
    )


def _project_qkv(params, x, cfg: ArchConfig, positions):
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ params["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ params["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(
    params: dict,
    x: torch.Tensor,                    # (B, S, d)
    cfg: ArchConfig,
    *,
    q_offset: int = 0,
    layout=None,
) -> torch.Tensor:
    """Full-sequence attention with no cache (the encoder's forward and
    the train step's).  Returns (B, S, d); with a ``layout`` whose ``wq``
    is split over ``model``, on this rank's heads (module docstring)."""
    if layout is not None and params["wq"].shape[-1] != cfg.q_dim:
        if cfg.num_heads % layout.tp_size == 0:
            return _attention_sharded(params, x, cfg, layout, q_offset)
        params = {k: ranks.gather(w, layout.tp, w.dim() - 1 if k != "wo" else 0, layout.mesh,
                                  tags=("tensor parallel",) * 2, reduce=False)
                  if k in ("wq", "wk", "wv", "wo") and w.shape != _whole(k, cfg) else w
                  for k, w in params.items()}
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device) + q_offset
    q, k, v = _project_qkv(params, x, cfg, positions)
    y = attn_ops.attention(
        q, k, v, causal=cfg.causal, window=cfg.sliding_window, q_offset=q_offset
    )
    return y.reshape(b, s, cfg.q_dim) @ params["wo"]


def _whole(leaf: str, cfg: ArchConfig) -> tuple:
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}[leaf]


def _attention_sharded(params, x, cfg: ArchConfig, layout, q_offset: int) -> torch.Tensor:
    b, s, _ = x.shape
    hd = cfg.head_dim
    rows = b * layout.batch_size
    h = layout.enter(x)
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    n_q = wq.shape[-1] // hd
    q = (h @ wq).reshape(b, s, n_q, hd)
    local_kv = wk.shape[-1] != cfg.kv_dim and cfg.num_kv_heads % layout.tp_size == 0
    if not local_kv:
        if wk.shape[-1] == cfg.kv_dim:          # replicated: each rank adds a part of its gradient
            wk, wv = layout.enter(wk), layout.enter(wv)
        else:                                   # split inside a head: gather over model
            wk = ranks.gather(wk, layout.tp, wk.dim() - 1, layout.mesh, tags=("tensor parallel",) * 2)
            wv = ranks.gather(wv, layout.tp, wv.dim() - 1, layout.mesh, tags=("tensor parallel",) * 2)
    k = (h @ wk).reshape(b, s, -1, hd)
    v = (h @ wv).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, layout.enter(params["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, layout.enter(params["k_norm"]), cfg.norm_eps)
    positions = torch.arange(s, device=x.device) + q_offset
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = layout.check(q, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_heads, hd))
    if local_kv:
        k = layout.check(k, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_kv_heads, hd))
        v = layout.check(v, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_kv_heads, hd))
    else:
        k = layout.check(k, ("batch", "act_seq", "act_kv", None), (rows, s, cfg.num_kv_heads, hd))
        v = layout.check(v, ("batch", "act_seq", "act_kv", None), (rows, s, cfg.num_kv_heads, hd))
        # the KV head of each local query head (GQA: h // group), one a query head
        first = layout.tp_index * n_q
        read = torch.arange(first, first + n_q, device=x.device) // (cfg.num_heads // cfg.num_kv_heads)
        k, v = k.index_select(2, read), v.index_select(2, read)
    y = attn_ops.attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window, q_offset=q_offset)
    y = layout.check(y, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_heads, hd))
    return layout.exit(y.reshape(b, s, n_q * hd) @ params["wo"])


def attention_decode(
    params: dict,
    x: torch.Tensor,                    # (B, 1, d)
    cache: KVCache,
    cfg: ArchConfig,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the KV cache. Returns ((B,1,d), cache)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per sequence, got {s}")
    pos = torch.full((1,), cache.index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos)

    c = cache.k.shape[1]
    slot = cache.index % c if cfg.sliding_window else min(cache.index, c - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    cache.positions[slot] = cache.index

    # decode is a memory-bound gather/softmax: the plain version, as in the
    # reference (its flash kernel falls back for kv_positions)
    y = attention_reference(
        q, cache.k, cache.v,
        causal=cfg.causal,
        window=cfg.sliding_window,
        q_offset=cache.index,
        kv_positions=cache.positions,
    )
    y = y.reshape(b, 1, cfg.q_dim) @ params["wo"]
    return y, cache._replace(index=cache.index + 1)


def prefill_cache(
    params: dict,
    x: torch.Tensor,                    # (B, S, d)
    cfg: ArchConfig,
    max_len: int,
) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also materializes the cache for
    subsequent decode.  Returns ((B,S,d), cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    y = attn_ops.attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
    y = y.reshape(b, s, cfg.q_dim) @ params["wo"]

    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device)
    c = cache.k.shape[1]
    if cfg.sliding_window and s > c:
        # keep the last `window` keys, ring-aligned so slot = pos % window
        last = torch.arange(s - c, s, device=x.device)
        sel = last[torch.argsort(torch.remainder(last, c))]
        cache.k.copy_(k[:, sel])
        cache.v.copy_(v[:, sel])
        cache.positions.copy_(sel.to(torch.int32))
    else:
        if s > c:
            raise ValueError(f"prompt of {s} tokens does not fit a cache of {c}")
        cache.k[:, :s] = k
        cache.v[:, :s] = v
        cache.positions[:s] = positions.to(torch.int32)
    return y, cache._replace(index=s)
