"""Analytical FLOPs/bytes counters for the model zoo (roofline inputs);
a pure-float copy of the reference's ``costs/counts.py``.

Closed-form operation counts for the modules the zoo is built from —
attention, Mamba2 SSD, the paper's LSTM, blocked-int8 dequant, dense and
MoE FFNs — and their composition into **per-request** counts for any
registered :class:`repro_torch.configs.base.ArchConfig`.

Conventions (the reference's, which pins them against its HLO parser):

* **FLOPs** are *dot FLOPs*: ``2 · |out| · contracted`` per matmul — the
  convention ``parse_hlo_costs`` applies to ``dot`` ops, so analytical and
  HLO-parsed counts are directly comparable.  Elementwise work (softmax,
  gating, decay) is excluded on both sides.
* **Bytes** are *minimal traffic*: every tensor read once + outputs
  written once (the flash/fused ideal).  The HLO materialization-boundary
  model counts intermediate writes too, so parsed bytes upper-bound these.

Everything is a pure float computation — no torch import, safe at CLI
``--help`` time.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

__all__ = [
    "OpCounts",
    "matmul_counts",
    "attention_counts",
    "ssd_counts",
    "lstm_counts",
    "dequant_counts",
    "ffn_counts",
    "layer_counts",
    "RequestCounts",
    "request_counts",
]


@dataclasses.dataclass(frozen=True)
class OpCounts:
    """FLOPs + minimal HBM traffic of one module invocation."""

    flops: float = 0.0
    hbm_bytes: float = 0.0

    def __add__(self, other: "OpCounts") -> "OpCounts":
        return OpCounts(self.flops + other.flops, self.hbm_bytes + other.hbm_bytes)

    def scale(self, k: float) -> "OpCounts":
        """This module executed ``k`` times (layers, decode steps, ...)."""
        return OpCounts(k * self.flops, k * self.hbm_bytes)

    @property
    def arithmetic_intensity(self) -> float:
        """FLOP per HBM byte — which roofline regime the module lives in."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


# ---------------------------------------------------------------------------
# Module counters
# ---------------------------------------------------------------------------
def matmul_counts(
    m: int, k: int, n: int, batch: int = 1, dtype_bytes: int = 2,
    weights_shared: bool = True,
) -> OpCounts:
    """``(batch, m, k) @ (k, n)`` — activations per batch element, the
    weight matrix read once when ``weights_shared`` (the serving case)."""
    flops = 2.0 * batch * m * k * n
    acts = batch * (m * k + m * n)
    w = (1 if weights_shared else batch) * k * n
    return OpCounts(flops, float(dtype_bytes) * (acts + w))


def attention_counts(
    batch: int,
    q_len: int,
    kv_len: int,
    num_heads: int,
    head_dim: int,
    num_kv_heads: int | None = None,
    window: int = 0,
    dtype_bytes: int = 2,
) -> OpCounts:
    """Scaled-dot-product attention core (no projections).

    FLOPs: the two dots, ``QKᵀ`` and ``PV`` — ``4·B·H·q·kv_eff·D`` with
    ``kv_eff = min(kv_len, window)`` under sliding-window attention (the
    full square at ``window=0``; causality is *not* halved, matching the
    dense XLA reference path the conformance suite lowers).

    Bytes: flash convention — Q, K, V read once, O written once, no S×S
    score materialization (KV at ``num_kv_heads`` before any repeat).
    """
    kvh = num_heads if num_kv_heads is None else num_kv_heads
    kv_eff = min(kv_len, window) if window else kv_len
    flops = 4.0 * batch * num_heads * q_len * kv_eff * head_dim
    q_bytes = batch * q_len * num_heads * head_dim
    kv_bytes = 2 * batch * kv_eff * kvh * head_dim
    o_bytes = batch * q_len * num_heads * head_dim
    return OpCounts(flops, float(dtype_bytes) * (q_bytes + kv_bytes + o_bytes))


def ssd_counts(
    batch: int,
    seq: int,
    num_heads: int,
    head_dim: int,
    state: int,
    num_groups: int = 1,
    dtype_bytes: int = 2,
) -> OpCounts:
    """Mamba2 SSD mixer core (no projections), recurrent semantics.

    FLOPs: the output contraction ``y_t = C_t · h_t`` — ``2·B·S·H·P·N``
    dot FLOPs per sequence (the subset XLA lowers to ``dot``; the state
    update ``h ← decay·h + (Δt·x)⊗B`` is elementwise on both sides of the
    conformance check).  Bytes: x in, y out, B/C streams at ``num_groups``,
    one state residency per sequence.
    """
    flops = 2.0 * batch * seq * num_heads * head_dim * state
    io = 2 * batch * seq * num_heads * head_dim              # x + y
    bc = 2 * batch * seq * num_groups * state                # B + C
    st = batch * num_heads * head_dim * state                # state resident
    return OpCounts(flops, float(dtype_bytes) * (io + bc + st))


def lstm_counts(
    batch: int, seq: int, input_dim: int, hidden: int, dtype_bytes: int = 4
) -> OpCounts:
    """The paper's LSTM accelerator: per step ``x_t@W_ih + h@W_hh`` →
    ``8·B·S·H·(I+H)`` dot FLOPs over the sequence.  Bytes: the recurrent
    weights are re-read every scan step (exactly how the while-body HLO
    charges them — the scan-over-layers multiplication the conformance
    suite pins), activations once."""
    flops = 8.0 * batch * seq * hidden * (input_dim + hidden)
    w = seq * 4 * hidden * (input_dim + hidden)              # per-step re-read
    acts = batch * seq * (input_dim + hidden) + 2 * batch * hidden
    return OpCounts(flops, float(dtype_bytes) * (w + acts))


def dequant_counts(rows: int, cols: int, group: int = 128) -> OpCounts:
    """Blocked int8 → bf16 dequantize: zero dot FLOPs; bytes are exact
    (int8 weights + fp32 scales in, bf16 out) — the HLO parse matches
    bit-for-bit on the fused module."""
    return OpCounts(0.0, rows * cols * 1.0 + rows * (cols // group) * 4.0 + rows * cols * 2.0)


def ffn_counts(
    batch: int,
    tokens: int,
    d_model: int,
    d_ff: int,
    mlp_kind: str = "swiglu",
    experts_per_token: int = 0,
    num_experts: int = 0,
    dtype_bytes: int = 2,
) -> OpCounts:
    """Dense (or top-k MoE) FFN: ``mats`` matrices of ``d·d_ff`` per
    active expert, plus the (always dense) router."""
    mats = 3 if mlp_kind == "swiglu" else 2
    active = max(experts_per_token, 1)
    flops = 2.0 * batch * tokens * active * mats * d_model * d_ff
    w = active * mats * d_model * d_ff
    acts = batch * tokens * (d_model + d_ff)
    counts = OpCounts(flops, float(dtype_bytes) * (w + acts))
    if num_experts:
        counts = counts + matmul_counts(
            tokens, d_model, num_experts, batch=batch, dtype_bytes=dtype_bytes
        )
    return counts


# ---------------------------------------------------------------------------
# Per-layer / per-request composition over an ArchConfig
# ---------------------------------------------------------------------------
def layer_counts(
    cfg: ArchConfig,
    layer_idx: int,
    batch: int,
    q_len: int,
    kv_len: int,
    dtype_bytes: int = 2,
) -> OpCounts:
    """One transformer/SSM layer processing ``q_len`` new tokens against a
    ``kv_len``-token context (``q_len == kv_len`` for prefill, ``1`` new
    token against a growing cache for decode)."""
    d = cfg.d_model
    out = OpCounts()
    if cfg.layer_kind(layer_idx) == "attn":
        # q/k/v/o projections
        proj = cfg.q_dim * 2 + cfg.kv_dim * 2
        out = out + matmul_counts(q_len, d, proj, batch=batch, dtype_bytes=dtype_bytes)
        out = out + attention_counts(
            batch, q_len, kv_len, cfg.num_heads, cfg.head_dim,
            num_kv_heads=cfg.num_kv_heads, window=cfg.sliding_window,
            dtype_bytes=dtype_bytes,
        )
    else:
        di, ns, g = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_groups
        in_out = 2 * di + 2 * g * ns + cfg.ssm_num_heads + di  # in_proj + out_proj cols
        out = out + matmul_counts(q_len, d, in_out, batch=batch, dtype_bytes=dtype_bytes)
        out = out + ssd_counts(
            batch, q_len, cfg.ssm_num_heads, cfg.ssm_head_dim, ns,
            num_groups=g, dtype_bytes=dtype_bytes,
        )
    if cfg.layer_is_moe(layer_idx):
        out = out + ffn_counts(
            batch, q_len, d, cfg.d_ff, cfg.mlp_kind,
            experts_per_token=cfg.experts_per_token,
            num_experts=cfg.num_experts, dtype_bytes=dtype_bytes,
        )
    elif cfg.d_ff:
        out = out + ffn_counts(batch, q_len, d, cfg.d_ff, cfg.mlp_kind,
                               dtype_bytes=dtype_bytes)
    return out


@dataclasses.dataclass(frozen=True)
class RequestCounts:
    """One inference request = prefill over the prompt + autoregressive
    decode, for a whole batch of sequences."""

    model: str
    batch: int
    prefill_len: int
    decode_len: int
    prefill: OpCounts
    decode: OpCounts            # summed over all decode steps
    weight_bytes: float         # full parameter footprint (configuration load)
    input_bytes: float          # host → accelerator per request
    output_bytes: float         # accelerator → host per request

    @property
    def total(self) -> OpCounts:
        return self.prefill + self.decode

    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "batch": self.batch,
            "prefill_len": self.prefill_len,
            "decode_len": self.decode_len,
            "prefill_flops": self.prefill.flops,
            "prefill_bytes": self.prefill.hbm_bytes,
            "decode_flops": self.decode.flops,
            "decode_bytes": self.decode.hbm_bytes,
            "weight_bytes": self.weight_bytes,
            "input_bytes": self.input_bytes,
            "output_bytes": self.output_bytes,
            "arithmetic_intensity": self.total.arithmetic_intensity,
        }


def request_counts(
    cfg: ArchConfig,
    batch: int = 1,
    prefill_len: int = 2048,
    decode_len: int = 128,
    dtype_bytes: int = 2,
) -> RequestCounts:
    """Per-request FLOPs/bytes for ``batch`` sequences through ``cfg``.

    Prefill runs every layer once over ``prefill_len`` tokens; decode runs
    ``decode_len`` single-token steps against the growing KV context
    (window-capped when the config slides), re-reading the *active*
    parameters each step — the classic memory-bound decode model.  The LM
    head is charged once per generated token plus once for the prompt's
    final position.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1, got {prefill_len}")
    if decode_len < 0:
        raise ValueError(f"decode_len must be >= 0, got {decode_len}")

    active_w = float(cfg.param_count(active_only=True)) * dtype_bytes
    prefill = OpCounts()
    per_decode = OpCounts()
    for layer in range(cfg.num_layers):
        prefill = prefill + layer_counts(
            cfg, layer, batch, prefill_len, prefill_len, dtype_bytes
        )
        # decode cost at the mean context length (closed-form sum over steps)
        mean_ctx = prefill_len + (decode_len + 1) // 2
        per_decode = per_decode + layer_counts(cfg, layer, batch, 1, mean_ctx, dtype_bytes)
    # LM head (+ final-position logits of the prefill)
    if cfg.vocab_size:
        head = matmul_counts(1, cfg.d_model, cfg.vocab_size, batch=batch,
                             dtype_bytes=dtype_bytes)
        prefill = prefill + head
        per_decode = per_decode + head
    # prefill streams the full active weights once; decode re-streams them
    # every step (weight traffic beyond what the per-layer matmuls counted
    # is already included there — nothing extra to add)
    decode = per_decode.scale(decode_len)
    # decode is weight-bound: floor its traffic at active params per step
    decode = OpCounts(decode.flops,
                      max(decode.hbm_bytes, decode_len * active_w))
    prefill = OpCounts(prefill.flops, max(prefill.hbm_bytes, active_w))
    return RequestCounts(
        model=cfg.name,
        batch=batch,
        prefill_len=prefill_len,
        decode_len=decode_len,
        prefill=prefill,
        decode=decode,
        weight_bytes=float(cfg.param_count(active_only=False)) * dtype_bytes,
        input_bytes=4.0 * batch * prefill_len,          # int32 token ids
        output_bytes=4.0 * batch * max(decode_len, 1),  # int32 generations
    )
