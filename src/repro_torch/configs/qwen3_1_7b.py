"""qwen3-1.7b — [hf:Qwen/Qwen3-8B family; hf].  Dense, qk_norm, GQA kv=8,
tied embeddings (Qwen3 small models tie the LM head)."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b-reduced",
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
        tie_embeddings=True,
        subquadratic=False,
    )


register(full, reduced)
