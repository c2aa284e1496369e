"""GQA attention block: qk_norm, RoPE, sliding window, KV cache (port of
``repro.models.attention``: prefill with its cache, decode, and the
cache-free forward the encoder runs).

Cache layout: ``KVCache(k, v, positions, index)`` where ``k``/``v`` are
(B, C, KVH, D) ring/linear buffers, ``positions`` (C,) holds each slot's
absolute position (−1 = uninitialized), and ``index`` is the next absolute
position.  Unlike the reference's immutable arrays, decode writes the new
key and value into the buffers in place (saving a copy of the cache per
step) and returns the same cache with ``index`` advanced.

**Serving on a mesh of ranks** (``layout``: a ``sharding.Layout`` of the
serving step, ``models/decoder.py``).  :func:`prefill_cache` and
:func:`attention_decode` run on this rank's rows of the batch and, where
the query heads divide over ``model``, on its query heads, through the
flash kernel in the prefill and the plain version in decode (as on one
card and in the reference).  The cache is a local block: its batch is this
rank's rows (over (pod, data), the reference's ``cache_batch``), and it
holds only the KV heads this rank's query heads read (:func:`_kv_read`),
where the reference keeps every KV head on each rank; the same numbers.
Where the query heads do not divide, the weights are gathered over
``model`` and every head runs on every rank.

**A cache split over its sequence** (:func:`cache_seq_axes`): the rule
``cache_seq`` (``model`` under ``shard_cache_seq_over_model``) or, in a
long-context step, ``long_cache_seq`` (``data``, or ``model`` under
``shard_long_cache_over_model``) cuts the slots into one block a rank;
``positions`` stays whole on every rank, as the reference's ``P()``.  The
prefill attends over the whole local sequence first and then keeps its
block, as the reference does; it leaves a ring buffer (a sliding window)
whole, as the reference's prefill does, and the first decode step keeps
the ring's block; in a long-context step a ring (at most the window)
stays whole.  In decode the rank whose block holds the slot writes the
new key and value; each rank scores every query head it runs over its
block in fp32, and the ranks combine the partials over the split axis
(:func:`_combined`: the max, then the sums of the weights and the
weighted values) before ``wo``: the reference's decode is its plain
path, so no kernel is involved.  Where ``model`` splits the sequence it
cannot also split the heads: the block holds every KV head, q is
assembled whole from each rank's columns, and each rank keeps its query
heads after the combine.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import attention_reference, repeat_kv
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
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
    kv_heads: int | None = None, seq_blocks: int = 1,
) -> KVCache:
    """Empty cache on ``device`` (the card by default; raises without one
    unless ``device="cpu"``; ``meta`` for shapes alone).  Under SWA the
    buffer is bounded by the window.  ``kv_heads`` (all by default) and
    ``seq_blocks`` (one of that many blocks of the slots; ``positions``
    stays whole) are a serving rank's block (:func:`cache_block`)."""
    device = resolve_device(device)
    c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, c // seq_blocks, cfg.num_kv_heads if kv_heads is None else kv_heads, cfg.head_dim)
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


def _heads_split(params: dict, cfg: ArchConfig, layout) -> bool:
    """Whether this serving rank runs on its own query heads."""
    return (layout is not None and params["wq"].shape[-1] != cfg.q_dim
            and cfg.num_heads % layout.tp_size == 0)


def _whole_heads(params: dict, cfg: ArchConfig, layout) -> dict:
    """``params`` with every projection split over ``model`` gathered (the
    serving step where the query heads do not divide)."""
    if layout is None:
        return params
    return {k: ranks.all_gather(w, layout.tp, w.dim() - 1 if k != "wo" else 0, layout.mesh,
                                tag="tensor parallel")
            if k in ("wq", "wk", "wv", "wo") and w.shape != _whole(k, cfg) else w
            for k, w in params.items()}


def _kv_read(cfg: ArchConfig, layout, n_q: int) -> tuple[int, int]:
    """(first, count) of the KV heads that this rank's ``n_q`` query heads
    read (GQA: query head h reads KV head h // group)."""
    group = cfg.num_heads // cfg.num_kv_heads
    first = layout.tp_index * n_q
    lo = first // group
    return lo, (first + n_q - 1) // group + 1 - lo


def _seq_logical(long_context: bool) -> str:
    return "long_cache_seq" if long_context else "cache_seq"


def cache_seq_axes(cfg: ArchConfig, layout, rows: int, slots: int, long_context: bool = False) -> tuple:
    """The live mesh axes a serving rank's cache of ``slots`` positions
    (``rows`` of them a rank) splits its sequence over in decode (module
    docstring): the ``cache_seq`` rule, or ``long_cache_seq`` in a long
    cell, where a ring buffer (at most the window) stays whole."""
    if layout is None or (long_context and cfg.sliding_window):
        return ()
    axes = layout.seq_axes(_seq_logical(long_context), (rows * layout.batch_size, slots))
    if len(axes) > 1:
        raise NotImplementedError(f"a cache sequence split over {axes}: the rules name one axis")
    return axes


def cache_heads(cfg: ArchConfig, layout, seq_axes: tuple = ()) -> int:
    """How many KV heads a serving rank's cache holds (module docstring):
    every KV head where ``seq_axes`` (:func:`cache_seq_axes`) takes
    ``model``."""
    if layout is None or layout.tp is None or cfg.num_heads % layout.tp_size or "model" in seq_axes:
        return cfg.num_kv_heads
    return _kv_read(cfg, layout, cfg.num_heads // layout.tp_size)[1]


def cache_block(cfg: ArchConfig, layout, rows: int, max_len: int, long_context: bool = False) -> tuple[int, int]:
    """(KV heads, sequence blocks) of a serving rank's decode cache: the
    block a decode step keeps (a prefill's ring buffer stays whole until
    the first decode step takes its block)."""
    if not cfg.num_kv_heads:                    # attention-free: no KV cache
        return 0, 1
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    seq = cache_seq_axes(cfg, layout, rows, slots, long_context)
    return cache_heads(cfg, layout, seq), math.prod(layout.mesh.shape[a] for a in seq) if seq else 1


def _local_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig, layout, positions):
    """q on this rank's query heads, k and v on the KV heads they read
    (:func:`_kv_read`), RoPE applied; → (q, k, v, the local KV head of
    each local query head)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    n_q = params["wq"].shape[-1] // hd
    lo, n_kv = _kv_read(cfg, layout, n_q)
    wk, wv = params["wk"], params["wv"]
    split = wk.shape[-1] != cfg.kv_dim
    if not (split and cfg.num_kv_heads % layout.tp_size == 0):   # else the block is the heads read
        if split:                                # split inside a head: gather over model
            wk = ranks.all_gather(wk, layout.tp, wk.dim() - 1, layout.mesh, tag="tensor parallel")
            wv = ranks.all_gather(wv, layout.tp, wv.dim() - 1, layout.mesh, tag="tensor parallel")
        wk, wv = wk[:, lo * hd:(lo + n_kv) * hd], wv[:, lo * hd:(lo + n_kv) * hd]
    q = (x @ params["wq"]).reshape(b, s, n_q, hd)
    k = (x @ wk).reshape(b, s, n_kv, hd)
    v = (x @ wv).reshape(b, s, n_kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    first, group = layout.tp_index * n_q, cfg.num_heads // cfg.num_kv_heads
    read = tuple((first + j) // group - lo for j in range(n_q))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, read


def _columns(x: torch.Tensor, w: torch.Tensor, whole: int, layout, seq_to: int = 0) -> torch.Tensor:
    """``x @ w`` with all ``whole`` columns where ``w`` holds this rank's
    block of them (split over ``model``): gathered over ``model``, or, with
    ``seq_to``, the sequence padded with zeros to ``seq_to`` positions and
    exchanged so that this rank keeps its block of them (``model``'s
    index) with every column."""
    y = x @ w
    if w.shape[-1] == whole:
        return y if not seq_to else _seq_block(F.pad(y, (0, 0, 0, seq_to - y.shape[1])), ("model",), layout)
    if not seq_to:
        return ranks.all_gather(y, layout.tp, y.dim() - 1, layout.mesh, tag="tensor parallel")
    y = F.pad(y, (0, 0, 0, seq_to - y.shape[1]))
    return ranks.all_to_all(y, layout.tp, 1, 2, layout.mesh, tag="cache split")


def _seq_block(t: torch.Tensor, seq: tuple, layout) -> torch.Tensor:
    """This rank's block of ``t``'s dim 1 split over ``seq``."""
    n = math.prod(layout.mesh.shape[a] for a in seq)
    return t.chunk(n, 1)[layout.mesh.index(seq)]


def _whole_kv(params: dict, x: torch.Tensor, cfg: ArchConfig, layout, positions, seq_to: int = 0):
    """k and v on every KV head (RoPE applied) from this rank's columns of
    ``wk`` / ``wv`` (:func:`_columns`): over the whole sequence, or over
    this rank's block of ``seq_to`` positions (``positions``: its
    positions)."""
    b = x.shape[0]
    hd = cfg.head_dim
    k = _columns(x, params["wk"], cfg.kv_dim, layout, seq_to)
    v = _columns(x, params["wv"], cfg.kv_dim, layout, seq_to)
    k = k.reshape(b, k.shape[1], cfg.num_kv_heads, hd)
    v = v.reshape(b, v.shape[1], cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def _whole_q(params: dict, x: torch.Tensor, cfg: ArchConfig, layout, positions) -> torch.Tensor:
    """q on every query head from this rank's columns of ``wq``."""
    b, s, _ = x.shape
    q = _columns(x, params["wq"], cfg.q_dim, layout).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin)


def _grouped(k: torch.Tensor, read: tuple) -> torch.Tensor:
    """``k`` as the attention ops take it for the local query heads (``read``:
    the local KV head of each): as is where query head j reads KV head
    j // (n_q / n_kv), else one KV head a query head."""
    n_q, n_kv = len(read), k.shape[2]
    if n_q % n_kv == 0 and read == tuple(j // (n_q // n_kv) for j in range(n_q)):
        return k
    return k.index_select(2, torch.tensor(read, device=k.device))


def _check_cache(k: torch.Tensor, cfg: ArchConfig, layout, slots: int, seq_logical=None,
                 every_head: bool = False) -> torch.Tensor:
    """The reference's cache placement as a block-shape assertion: the
    batch over ``cache_batch``, the ``slots`` positions whole or split by
    the rule ``seq_logical``; every KV head where ``every_head`` (the
    decode step splits the sequence over ``model``), else the KV heads over
    ``model`` where they divide, else the heads this rank reads."""
    b, _, n_kv, hd = k.shape
    heads_axis, heads = (None, n_kv)
    if every_head:
        heads = cfg.num_kv_heads
    elif cfg.num_kv_heads % layout.tp_size == 0:
        heads_axis, heads = "act_heads", cfg.num_kv_heads
    return layout.check(k, ("cache_batch", seq_logical, heads_axis, None), (b * layout.batch_size, slots, heads, hd))


def _combined(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_positions: torch.Tensor, q_pos: int,
              cfg: ArchConfig, layout, seq: tuple) -> torch.Tensor:
    """One query a row against this rank's block of the cache, combined
    with the other blocks over ``seq``: each head's scores over the block
    in fp32 (masked as the plain version masks them), the max over every
    block, then the sums of the weights and of the weighted values over
    every block → (B, 1, H, D); a row no block holds a key for gives 0."""
    ct = torch.promote_types(q.dtype, torch.float32)
    h = q.shape[2]
    k, v = repeat_kv(k, h), repeat_kv(v, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * q.shape[3] ** -0.5
    mask = kv_positions >= 0
    if cfg.causal:
        mask = mask & (kv_positions <= q_pos)
    if cfg.sliding_window:
        mask = mask & (kv_positions > q_pos - cfg.sliding_window)
    logits = torch.where(mask, logits, float("-inf"))
    top = ranks.all_gather(logits.amax(-1, keepdim=True), seq, 3, layout.mesh,
                           tag="attention combine").amax(-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(top), top, 0.0))
    part = torch.cat([torch.einsum("bhqk,bkhd->bhqd", p, v.to(ct)), p.sum(-1, keepdim=True)], -1)
    part = ranks.psum(part, seq, layout.mesh, tag="attention combine")
    o, total = part[..., :-1], part[..., -1:]
    y = torch.where(total > 0, o / total, 0.0)
    return y.permute(0, 2, 1, 3).to(q.dtype)


def attention_decode(
    params: dict,
    x: torch.Tensor,                    # (B, 1, d)
    cache: KVCache,
    cfg: ArchConfig,
    layout=None,
    long_context: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against the KV cache. Returns ((B,1,d), cache);
    with a serving ``layout``, on this rank's rows, heads and cache block,
    combined over the axis that splits the cache's sequence (module
    docstring)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per sequence, got {s}")
    pos = torch.full((1,), cache.index, dtype=torch.int32, device=x.device)
    slots = cache.positions.shape[0]
    seq = cache_seq_axes(cfg, layout, b, slots, long_context)
    split = _heads_split(params, cfg, layout)
    every_head = split and "model" in seq       # the block holds every KV head: so does q
    if every_head:
        q = _whole_q(params, x, cfg, layout, pos)
        k_new, v_new = _whole_kv(params, x, cfg, layout, pos)
    elif split:
        q, k_new, v_new, read = _local_qkv(params, x, cfg, layout, pos)
    else:
        params = _whole_heads(params, cfg, layout)
        q, k_new, v_new = _project_qkv(params, x, cfg, pos)

    slot = cache.index % slots if cfg.sliding_window else min(cache.index, slots - 1)
    k_buf, v_buf, lo, block = cache.k, cache.v, 0, slots
    if seq:
        block = slots // math.prod(layout.mesh.shape[a] for a in seq)
        lo = layout.mesh.index(seq) * block
        if k_buf.shape[1] == slots:             # a prefill's ring, whole: keep this rank's block
            k_buf, v_buf = k_buf[:, lo:lo + block].clone(), v_buf[:, lo:lo + block].clone()
    if lo <= slot < lo + block:                 # the rank whose block holds the slot writes it
        k_buf[:, slot - lo] = k_new[:, 0]
        v_buf[:, slot - lo] = v_new[:, 0]
    cache.positions[slot] = cache.index
    if layout is not None:
        _check_cache(k_buf, cfg, layout, slots, _seq_logical(long_context) if seq else None, "model" in seq)
    k_all, v_all = k_buf, v_buf
    if split and not every_head:
        k_all, v_all = _grouped(k_all, read), _grouped(v_all, read)

    if seq:
        y = _combined(q, k_all, v_all, cache.positions[lo:lo + block], cache.index, cfg, layout, seq)
        if every_head:                          # back to this rank's heads before wo
            n_q = cfg.num_heads // layout.tp_size
            y = y[:, :, layout.tp_index * n_q:(layout.tp_index + 1) * n_q]
    else:
        # decode is a memory-bound gather/softmax: the plain version, as in the
        # reference (its flash kernel falls back for kv_positions)
        y = attention_reference(
            q, k_all, v_all,
            causal=cfg.causal,
            window=cfg.sliding_window,
            q_offset=cache.index,
            kv_positions=cache.positions,
        )
    y = y.reshape(b, 1, y.shape[2] * cfg.head_dim) @ params["wo"]
    if split:
        y = layout.exit(y)
    return y, KVCache(k_buf, v_buf, cache.positions, cache.index + 1)


def prefill_cache(
    params: dict,
    x: torch.Tensor,                    # (B, S, d)
    cfg: ArchConfig,
    max_len: int,
    layout=None,
    long_context: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence attention that also materializes the cache for
    subsequent decode.  Returns ((B,S,d), cache); with a serving
    ``layout``, on this rank's rows and heads, the cache a local block
    (module docstring)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    split = _heads_split(params, cfg, layout)
    if split:
        q, k, v, read = _local_qkv(params, x, cfg, layout, positions)
        rows = b * layout.batch_size
        q = layout.check(q, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_heads, cfg.head_dim))
        y = attn_ops.attention(q, _grouped(k, read), _grouped(v, read), causal=cfg.causal,
                               window=cfg.sliding_window)
        y = layout.check(y, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.num_heads, cfg.head_dim))
        y = layout.exit(y.reshape(b, s, -1) @ params["wo"])
    else:
        params = _whole_heads(params, cfg, layout)
        q, k, v = _project_qkv(params, x, cfg, positions)
        y = attn_ops.attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
        y = y.reshape(b, s, cfg.q_dim) @ params["wo"]

    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if s > slots and not cfg.sliding_window:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {slots}")
    seq = cache_seq_axes(cfg, layout, b, slots, long_context)      # the decode step's split
    keep = () if cfg.sliding_window else seq                       # a ring stays whole here
    n = math.prod(layout.mesh.shape[a] for a in keep) if keep else 1
    if split and "model" in seq:                # the cache holds every KV head
        if keep:
            lo = layout.mesh.index(keep) * (slots // n)
            k, v = _whole_kv(params, x, cfg, layout, torch.arange(lo, lo + slots // n, device=x.device), slots)
        else:
            k, v = _whole_kv(params, x, cfg, layout, positions)
    elif keep:
        k, v = (_seq_block(F.pad(t, (0, 0, 0, 0, 0, slots - s)), keep, layout) for t in (k, v))

    cache = init_cache(cfg, b, max_len, dtype=x.dtype, device=x.device, kv_heads=k.shape[2], seq_blocks=n)
    if cfg.sliding_window and s > slots:
        # keep the last `window` keys, ring-aligned so slot = pos % window
        last = torch.arange(s - slots, s, device=x.device)
        sel = last[torch.argsort(torch.remainder(last, slots))]
        cache.k.copy_(k[:, sel])
        cache.v.copy_(v[:, sel])
        cache.positions.copy_(sel.to(torch.int32))
    else:
        if keep:                                # this rank's block, zeros past the prompt
            cache.k.copy_(k)
            cache.v.copy_(v)
        else:
            cache.k[:, :s] = k
            cache.v[:, :s] = v
        cache.positions[:s] = positions.to(torch.int32)
    if layout is not None:
        _check_cache(cache.k, cfg, layout, slots, _seq_logical(long_context) if keep else None, "model" in seq)
    return y, cache._replace(index=s)
