"""internlm2-20b — [arXiv:2403.17297; hf].  Dense, GQA kv=8."""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b",
        family="dense",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92544,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internlm2-20b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


register(full, reduced)
