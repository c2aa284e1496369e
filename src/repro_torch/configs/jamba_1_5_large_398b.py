"""jamba-1.5-large-398b — [arXiv:2403.19887; hf].

Hybrid Mamba+attention 1:7 interleave (1 attention layer per 8-layer
period), MoE 16-expert top-2 on every other layer.  TPU adaptation note
(DESIGN.md §10): the Mamba layers use our Mamba2/SSD formulation
(d_state=128, head_dim=64) rather than Mamba-1's sequential selective scan —
the SSD chunked form maps onto the MXU, Mamba-1's scan does not.
Sub-quadratic (SSM + the 9 attention layers use windowed KV in long mode)
→ long_500k RUNS.
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,              # per-expert / dense FFN hidden
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_every=2,             # MoE on every other layer
        attn_every=8,            # 1 attention layer per 8 (1:7)
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        rope_theta=1_000_000.0,
        subquadratic=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b-reduced",
        family="hybrid",
        num_layers=8,            # one full interleave period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=4,
        experts_per_token=2,
        moe_every=2,
        attn_every=8,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        rope_theta=1_000_000.0,
        subquadratic=True,
    )


register(full, reduced)
