"""mixtral-8x7b — [arXiv:2401.04088; hf].

8-expert top-2 MoE on every layer, GQA kv=8, sliding-window attention
(4096) → sub-quadratic KV, so long_500k RUNS (window-bounded cache).
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,              # per-expert FFN hidden
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        moe_every=1,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        subquadratic=True,       # SWA bounds attention cost/cache
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=4,
        experts_per_token=2,
        moe_every=1,
        sliding_window=32,
        rope_theta=1_000_000.0,
        subquadratic=True,
    )


register(full, reduced)
