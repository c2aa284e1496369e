"""yi-6b — [arXiv:2403.04652; hf].  Llama-arch dense, GQA kv=4."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="yi-6b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_theta=5_000_000.0,
        subquadratic=False,
    )


register(full, reduced)
