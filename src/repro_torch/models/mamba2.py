"""Mamba-2 (SSD) mixer block + O(1) decode state (port of
``repro.models.mamba2``).

Block structure (Mamba-2 paper, §7): separate projections for z (gate),
x_inner, B, C, dt; short causal depthwise conv over [x;B;C]; SSD scan;
gated RMSNorm; output projection.  The prefill's scan goes through the SSD
kernel's wrapper (``kernels/ssd/ops.py``); decode's one-token state update
and the conv are plain PyTorch, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.common import Spec, rms_norm


class SSMCache(NamedTuple):
    state: torch.Tensor       # (B, H, P, N) fp32 SSD state
    conv: torch.Tensor        # (B, W-1, conv_dim) trailing conv inputs


def mamba2_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    g, n, h = cfg.ssm_num_groups, cfg.ssm_state, cfg.ssm_num_heads
    w = cfg.ssm_conv_width
    conv_dim = di + 2 * g * n
    return {
        "w_z": Spec((d, di), ("embed", "ssm_inner")),
        "w_x": Spec((d, di), ("embed", "ssm_inner")),
        "w_b": Spec((d, g * n), ("embed", None)),
        "w_c": Spec((d, g * n), ("embed", None)),
        "w_dt": Spec((d, h), ("embed", "ssm_inner")),
        "dt_bias": Spec((h,), ("ssm_inner",), init="zeros"),
        "a_log": Spec((h,), ("ssm_inner",), init="zeros"),   # A = −exp(a_log)
        "d_skip": Spec((h,), ("ssm_inner",), init="ones"),
        "conv_w": Spec((w, conv_dim), ("conv", "ssm_inner")),
        "conv_b": Spec((conv_dim,), ("ssm_inner",), init="zeros"),
        "out_norm": Spec((di,), ("norm",), init="ones"),
        "w_out": Spec((di, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, C), w (W, C) → (B, S, C)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(width))
    return y + b[None, None, :]


def _conv_step(x_t: torch.Tensor, conv_cache: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Single-step conv using the cached last W−1 inputs.
    x_t (B, C); conv_cache (B, W−1, C) → (y_t, new_cache)."""
    width = w.shape[0]
    window = torch.cat([conv_cache, x_t[:, None]], dim=1)            # (B, W, C)
    y = torch.einsum("bwc,wc->bc", window, w) + b[None, :]
    return y, window[:, -(width - 1):]


def _split_proj(params, x, cfg: ArchConfig):
    z = x @ params["w_z"]
    xin = x @ params["w_x"]
    bm = x @ params["w_b"]
    cm = x @ params["w_c"]
    dt = x @ params["w_dt"]
    return z, xin, bm, cm, dt


def _split_xbc(xbc: torch.Tensor, cfg: ArchConfig):
    gn = cfg.ssm_num_groups * cfg.ssm_state
    return torch.split(xbc, [cfg.ssm_d_inner, gn, gn], dim=-1)


def _dt_and_a(params, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + bias) and A = −exp(a_log), both in fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def mamba2_block(
    params: dict,
    x: torch.Tensor,              # (B, S, d)
    cfg: ArchConfig,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
    return_state: bool = False,
):
    """Full-sequence SSD mixer (prefill)."""
    b, s, _ = x.shape
    g, n, h, p = cfg.ssm_num_groups, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xin, bm, cm, dt = _split_proj(params, x, cfg)

    raw_xbc = torch.cat([xin, bm, cm], dim=-1)
    xbc = F.silu(_causal_conv(raw_xbc, params["conv_w"], params["conv_b"]))
    xin, bm, cm = _split_xbc(xbc, cfg)
    dt, a = _dt_and_a(params, dt)

    # views of xbc, no copies; pad the sequence to a chunk multiple after the
    # softplus (the SSD needs it; the tail is masked by dt = 0 ⇒ decay 1,
    # no state update)
    xh, bm2, cm2 = xin.reshape(b, s, h, p), bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
    pad = (-s) % chunk
    if pad:
        xh, dt, bm2, cm2 = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xh, dt, bm2, cm2))

    y, state = ssd_ops.ssd(
        xh, dt, a, bm2, cm2, params["d_skip"], chunk=chunk, init_state=init_state,
    )
    y = y[:, :s].reshape(b, s, cfg.ssm_d_inner)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps) * F.silu(z)
    out = y @ params["w_out"]
    if return_state:
        width = cfg.ssm_conv_width
        tail = raw_xbc[:, -(width - 1):]
        need = (width - 1) - tail.shape[1]
        if need > 0:
            tail = F.pad(tail, (0, 0, need, 0))
        # a copy: a view would keep the whole (B, S, conv_dim) input alive
        return out, SSMCache(state=state, conv=tail.clone())
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device="cuda") -> SSMCache:
    """Zero state and convolution tail on ``device`` (the card by default;
    raises without one unless ``device="cpu"``)."""
    device = resolve_device(device)
    g, n = cfg.ssm_num_groups, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * g * n
    return SSMCache(
        state=torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim, n),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype, device=device),
    )


def mamba2_decode(
    params: dict,
    x: torch.Tensor,              # (B, 1, d)
    cache: SSMCache,
    cfg: ArchConfig,
) -> tuple[torch.Tensor, SSMCache]:
    """O(1) single-token decode."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba2_decode takes one token, got {s}")
    g, n, h, p = cfg.ssm_num_groups, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xin, bm, cm, dt = _split_proj(params, x[:, 0], cfg)

    xbc = torch.cat([xin, bm, cm], dim=-1)
    xbc, new_conv = _conv_step(xbc, cache.conv, params["conv_w"], params["conv_b"])
    xin, bm, cm = _split_xbc(F.silu(xbc), cfg)
    dt, a = _dt_and_a(params, dt)

    y, new_state = ssd_ops.ssd_decode_step(
        xin.reshape(b, h, p), dt, a, bm.reshape(b, g, n), cm.reshape(b, g, n),
        params["d_skip"], cache.state,
    )
    y = y.reshape(b, cfg.ssm_d_inner)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps) * F.silu(z)
    out = (y @ params["w_out"])[:, None, :]
    return out, SSMCache(state=new_state, conv=new_conv)
