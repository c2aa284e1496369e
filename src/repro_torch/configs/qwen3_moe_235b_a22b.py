"""qwen3-moe-235b-a22b — [hf:Qwen/Qwen3-30B-A3B family; hf].

128-expert top-8 MoE on every layer, GQA kv=4, qk_norm.  Full quadratic
attention → long_500k skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,               # per-expert FFN hidden
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        moe_every=1,
        qk_norm=True,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        num_experts=8,
        experts_per_token=2,
        moe_every=1,
        qk_norm=True,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


register(full, reduced)
