"""hubert-xlarge — [arXiv:2106.07447; unverified].

Encoder-only audio transformer (same arch as wav2vec2).  The convolutional
waveform frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings of dim 512 which the model projects into d_model.  MHA (kv=16 ⇒
no grouping), bidirectional (non-causal), GELU MLP.  Encoder-only → no
decode step: decode_32k and long_500k are skipped (DESIGN.md §5).
"""
from repro_torch.configs.base import ArchConfig, register


def full() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        mlp_kind="gelu",
        frontend="audio",
        frontend_dim=512,        # conv feature-extractor output dim
        decode_supported=False,
        subquadratic=False,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-reduced",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=64,
        causal=False,
        mlp_kind="gelu",
        frontend="audio",
        frontend_dim=32,
        decode_supported=False,
        subquadratic=False,
    )


register(full, reduced)
