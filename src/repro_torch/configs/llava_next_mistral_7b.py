"""llava-next-mistral-7b — [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

VLM: Mistral-7B backbone; the vision tower + anyres tiling is a STUB —
``input_specs()`` provides precomputed CLIP-ViT-L/14 patch embeddings
(576 tokens of dim 1024 per image) which the model projects into d_model.
Full quadratic attention → long_500k is skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        frontend="vision",
        frontend_dim=1024,       # CLIP-ViT-L/14 patch embedding dim
        frontend_tokens=576,     # 24×24 patches per anyres base tile
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b-reduced",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        rope_theta=1_000_000.0,
        frontend="vision",
        frontend_dim=32,
        frontend_tokens=8,
        subquadratic=False,
    )


register(full, reduced)
