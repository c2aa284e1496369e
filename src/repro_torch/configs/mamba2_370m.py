"""mamba2-370m — [arXiv:2405.21060; unverified] (port of
``repro.configs.mamba2_370m``).

Attention-free SSM using SSD (state-space duality): 48 layers, d_model=1024,
d_state=128, expand=2 ⇒ d_inner=2048, head_dim=64 ⇒ 32 SSM heads.  No FFN
(the Mamba block is the whole layer).  O(1) decode state.
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,             # attention-free
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,                  # no FFN
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
        subquadratic=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        tie_embeddings=True,
        subquadratic=True,
    )


register(full, reduced)
