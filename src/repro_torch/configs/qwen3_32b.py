"""qwen3-32b — [hf:Qwen/Qwen3-8B family; hf].  Dense, qk_norm, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qk_norm=True,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


register(full, reduced)
