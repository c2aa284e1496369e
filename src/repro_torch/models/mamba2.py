"""Mamba-2 (SSD) mixer block + O(1) decode state (port of
``repro.models.mamba2``).

Block structure (Mamba-2 paper, §7): separate projections for z (gate),
x_inner, B, C, dt; short causal depthwise conv over [x;B;C]; SSD scan;
gated RMSNorm; output projection.  The prefill's scan goes through the SSD
kernel's wrapper (``kernels/ssd/ops.py``); decode's one-token state update
and the conv are plain PyTorch, as in the reference.

**On a mesh of ranks** (``layout``: a ``sharding.Layout`` of the serving
or the train step, ``models/decoder.py``).  As in the reference, the
heads go over ``model`` (``ssm_inner``) and ``w_b`` / ``w_c`` are
replicated: each rank projects z, x and dt on its heads, B and C on the
groups its heads read (all of them for one group), runs the conv on
those channels, the SSD kernel on its heads, and ``w_out`` on its rows,
the parts summed over ``model``.  Three places differ from one device:

* ``conv_w`` / ``conv_b`` are split over ``model`` along the concatenated
  [x; B; C] channels, in blocks that do not line up with a rank's heads
  (mamba2-370m on model 2: rank 1's block is x channels 1152–2047 and
  B and C): each rank gathers them over ``model`` (a few KB a layer,
  tag ``conv gather``) and keeps its heads' x channels and its groups' B
  and C channels;
* the gated RMSNorm normalizes over the whole d_inner: the sum of squares
  is summed over ``model`` (tag ``norm sum``);
* the decode cache (:class:`SSMCache`) is a local block: the state of
  this rank's rows and heads, and the conv tail of its channels.  The
  reference puts the state's heads on ``model`` only where the batch does
  not split, and keeps the conv tail whole
  (``src/repro/launch/dryrun_lib.py:104-110``); the port splits both
  wherever the heads divide (the same numbers; ``launch.dryrun_lib.
  batch_pspecs`` still returns the reference's specs).

Where the heads do not divide over ``model``, every leaf split over it is
gathered and every head runs on every rank.

Every collective there is one autograd differentiates
(``distributed/ranks.py``), so the train step runs the same code: ``x``
enters the local heads' region by ``grad_psum`` (each rank's projections
give a part of its gradient), as do ``w_b`` / ``w_c`` and ``out_norm``,
replicated leaves of which each rank reads its groups' or channels' part;
the conv's gathered gradient is summed back into each rank's block
(``ranks.gather``); the norm's sum of squares is summed over ``model``
both ways, forward and in the gradient, since every rank's channels read
it; ``w_out``'s parts are summed by ``Layout.exit``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
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


def _dt_and_a(params, dt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + bias) and A = −exp(a_log), both in fp32."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def local_sizes(cfg: ArchConfig, layout) -> tuple[int, int, int, int]:
    """(first head, heads, first group, groups) of a serving rank: its
    block of the heads where they and d_inner divide over ``model`` and a
    rank's heads read whole groups, else every head."""
    h, g = cfg.ssm_num_heads, cfg.ssm_num_groups
    if layout is None or layout.tp is None or h % layout.tp_size or cfg.ssm_d_inner % layout.tp_size:
        return 0, h, 0, g
    hl = h // layout.tp_size
    h0, per_group = layout.tp_index * hl, h // g
    if g == 1:
        return h0, hl, 0, 1
    if hl % per_group:
        return 0, h, 0, g
    return h0, hl, h0 // per_group, hl // per_group


def _whole(leaf: str, cfg: ArchConfig) -> int:
    """The whole size of a leaf's last dimension."""
    di, h = cfg.ssm_d_inner, cfg.ssm_num_heads
    return {"w_z": di, "w_x": di, "w_dt": h, "dt_bias": h, "a_log": h, "d_skip": h,
            "conv_w": di + 2 * cfg.ssm_num_groups * cfg.ssm_state, "conv_b": di + 2 * cfg.ssm_num_groups * cfg.ssm_state,
            "w_out": di}.get(leaf)


def _local_params(params: dict, cfg: ArchConfig, layout) -> dict:
    """A serving rank's leaves for its heads (module docstring): the
    blocks split over ``model`` as they are, the conv's channels gathered
    and picked, ``w_b`` / ``w_c`` and ``out_norm`` cut to its groups and
    channels; where the heads do not divide, every split leaf gathered."""
    h0, hl, g0, gl = local_sizes(cfg, layout)
    if hl == cfg.ssm_num_heads:        # every rank runs every head alike: its gradient is the whole's
        return {k: ranks.gather(w, layout.tp, 0 if k == "w_out" else w.dim() - 1, layout.mesh,
                                tags=("tensor parallel",) * 2, reduce=False)
                if _whole(k, cfg) is not None and w.shape[0 if k == "w_out" else -1] != _whole(k, cfg) else w
                for k, w in params.items()}
    p, n, di = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_d_inner
    out = dict(params)
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    if conv_b.shape[0] != _whole("conv_b", cfg):
        # each rank's gradient of the whole conv lies in its own channels: summed, each keeps its block
        conv_w = ranks.gather(conv_w, layout.tp, 1, layout.mesh, tags=("conv gather",) * 2)
        conv_b = ranks.gather(conv_b, layout.tp, 0, layout.mesh, tags=("conv gather",) * 2)
    gn, bc = cfg.ssm_num_groups * n, slice(g0 * n, (g0 + gl) * n)
    dev = conv_w.device
    cols = torch.cat([torch.arange(h0 * p, (h0 + hl) * p, device=dev),
                      torch.arange(di + bc.start, di + bc.stop, device=dev),
                      torch.arange(di + gn + bc.start, di + gn + bc.stop, device=dev)])
    out["conv_w"], out["conv_b"] = conv_w.index_select(1, cols), conv_b.index_select(0, cols)
    # replicated over model, each rank's gradient a part (its heads' or its channels'): entered
    out["w_b"], out["w_c"] = layout.enter(params["w_b"])[:, bc], layout.enter(params["w_c"])[:, bc]
    out["out_norm"] = layout.enter(params["out_norm"])[h0 * p:(h0 + hl) * p]
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig, layout) -> torch.Tensor:
    """RMSNorm(y) · silu(z) over the whole d_inner: with a ``layout`` whose
    ranks hold blocks of it, the sum of squares summed over ``model``."""
    if layout is None or y.shape[-1] == cfg.ssm_d_inner:
        return rms_norm(y, scale, cfg.norm_eps) * F.silu(z)
    yf = y.float()
    # summed both ways: every rank's channels read the sum, so its gradient is a part too
    sq = torch.sum(torch.square(yf), dim=-1, keepdim=True)
    sq = ranks.grad_psum(ranks.value_psum(sq, layout.tp, layout.mesh, tag="norm sum"), layout.tp, layout.mesh,
                         tag="norm sum")
    return (yf * torch.rsqrt(sq / cfg.ssm_d_inner + cfg.norm_eps) * scale.float()).to(y.dtype) * F.silu(z)


def _out(y: torch.Tensor, params: dict, cfg: ArchConfig, layout) -> torch.Tensor:
    """``w_out``: with a ``layout`` whose ranks hold rows of it, the parts
    summed over ``model``."""
    out = y @ params["w_out"]
    return layout.exit(out) if layout is not None and y.shape[-1] != cfg.ssm_d_inner else out


def mamba2_block(
    params: dict,
    x: torch.Tensor,              # (B, S, d)
    cfg: ArchConfig,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
    return_state: bool = False,
    layout=None,
):
    """Full-sequence SSD mixer (prefill); with a serving ``layout``, on
    this rank's rows and heads (module docstring)."""
    if layout is not None:
        params = _local_params(params, cfg, layout)
        if params["w_dt"].shape[-1] != cfg.ssm_num_heads:     # local heads: x enters their region
            x = layout.enter(x)
    b, s, _ = x.shape
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    h, g = params["w_dt"].shape[-1], params["w_b"].shape[-1] // n
    z, xin, bm, cm, dt = _split_proj(params, x, cfg)

    raw_xbc = torch.cat([xin, bm, cm], dim=-1)
    xbc = F.silu(_causal_conv(raw_xbc, params["conv_w"], params["conv_b"]))
    xin, bm, cm = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    dt, a = _dt_and_a(params, dt)

    # views of xbc, no copies; pad the sequence to a chunk multiple after the
    # softplus (the SSD needs it; the tail is masked by dt = 0 ⇒ decay 1,
    # no state update)
    xh, bm2, cm2 = xin.reshape(b, s, h, p), bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
    if layout is not None:
        rows = b * layout.batch_size
        xh = layout.check(xh, ("batch", "act_seq", "act_heads", None), (rows, s, cfg.ssm_num_heads, p))
    pad = (-s) % chunk
    if pad:
        xh, dt, bm2, cm2 = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (xh, dt, bm2, cm2))

    y, state = ssd_ops.ssd(
        xh, dt, a, bm2, cm2, params["d_skip"], chunk=chunk, init_state=init_state,
    )
    y = y[:, :s].reshape(b, s, h * p)
    out = _out(_gated_norm(y, z, params["out_norm"], cfg, layout), params, cfg, layout)
    if return_state:
        width = cfg.ssm_conv_width
        tail = raw_xbc[:, -(width - 1):]
        need = (width - 1) - tail.shape[1]
        if need > 0:
            tail = F.pad(tail, (0, 0, need, 0))
        # a copy: a view would keep the whole (B, S, conv_dim) input alive
        return out, SSMCache(state=state, conv=tail.clone())
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device="cuda", layout=None) -> SSMCache:
    """Zero state and convolution tail on ``device`` (the card by default;
    raises without one unless ``device="cpu"``); with a serving
    ``layout``, a rank's block (its heads and their channels)."""
    device = resolve_device(device)
    _, hl, _, gl = local_sizes(cfg, layout)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    return SSMCache(
        state=torch.zeros((batch, hl, p, n), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, hl * p + 2 * gl * n), dtype=dtype, device=device),
    )


def mamba2_decode(
    params: dict,
    x: torch.Tensor,              # (B, 1, d)
    cache: SSMCache,
    cfg: ArchConfig,
    layout=None,
) -> tuple[torch.Tensor, SSMCache]:
    """O(1) single-token decode; with a serving ``layout``, on this rank's
    rows, heads and cache block."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mamba2_decode takes one token, got {s}")
    if layout is not None:
        params = _local_params(params, cfg, layout)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    h, g = params["w_dt"].shape[-1], params["w_b"].shape[-1] // n
    z, xin, bm, cm, dt = _split_proj(params, x[:, 0], cfg)

    xbc = torch.cat([xin, bm, cm], dim=-1)
    xbc, new_conv = _conv_step(xbc, cache.conv, params["conv_w"], params["conv_b"])
    xin, bm, cm = torch.split(F.silu(xbc), [h * p, g * n, g * n], dim=-1)
    dt, a = _dt_and_a(params, dt)

    y, new_state = ssd_ops.ssd_decode_step(
        xin.reshape(b, h, p), dt, a, bm.reshape(b, g, n), cm.reshape(b, g, n),
        params["d_skip"], cache.state,
    )
    y = y.reshape(b, h * p)
    out = _out(_gated_norm(y, z, params["out_norm"], cfg, layout), params, cfg, layout)[:, None, :]
    return out, SSMCache(state=new_state, conv=new_conv)
