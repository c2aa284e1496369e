"""Plain PyTorch attention: GQA + causal + sliding window (port of
``repro.kernels.flash_attention.ref.attention_reference``).

The statement of the function the flash kernel computes, and the decode
path's attention over ring-buffer caches (``kv_positions``)."""
from __future__ import annotations

import torch


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) → (B, S, H, D) by repeating each kv head H/KVH times."""
    kvh = k.shape[2]
    if kvh == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // kvh, dim=2)


def _attend(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, Sk, H, D)   (kv heads pre-repeated)
    v: torch.Tensor,
    q_positions: torch.Tensor,        # (Sq,) absolute query positions
    kv_positions: torch.Tensor,       # (Sk,) absolute key positions; -1 invalid
    causal: bool,
    window: int,
    scale: float,
) -> torch.Tensor:
    ct = torch.promote_types(q.dtype, torch.float32)     # fp32, or float64 for float64 inputs
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    mask = (kv_positions >= 0)[None, :]
    if causal:
        mask = mask & (kv_positions[None, :] <= q_positions[:, None])
    if window:
        mask = mask & (kv_positions[None, :] > q_positions[:, None] - window)
    logits = torch.where(mask[None, None], logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully-masked rows (padded queries) → zeros, not NaN
    probs = torch.where(torch.any(mask, dim=-1)[None, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(ct))
    return out.to(q.dtype)


def attention_reference(
    q: torch.Tensor,                  # (B, Sq, H, D)
    k: torch.Tensor,                  # (B, Sk, KVH, D)
    v: torch.Tensor,                  # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: int = 0,                  # sliding window size; 0 = unbounded
    q_offset: int = 0,                # absolute position of query 0
    kv_positions: torch.Tensor | None = None,  # (Sk,) absolute key positions
                                               #  (ring-buffer caches); -1 invalid
    scale: float | None = None,
) -> torch.Tensor:
    """Softmax attention in fp32 (float64 for float64 inputs) with optional
    causal/sliding-window mask.

    Returns (B, Sq, H, D) in q.dtype.
    """
    sq, h, d = q.shape[1], q.shape[2], q.shape[3]
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {kvh}")
    scale = (d ** -0.5) if scale is None else scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device) if kv_positions is None else kv_positions
    return _attend(
        q, repeat_kv(k, h), repeat_kv(v, h), qpos, kpos, causal, window, scale
    )
