"""Architecture configuration system (port of ``repro.configs.base``).

The dataclasses are copied unchanged.  Every architecture of the
reference is registered (``repro_torch.configs``); the shape-cell helpers
of the dry-run tooling (``arch_shapes``, ``all_cells``) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Shapes (assigned to every LM-family arch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: seq_len × global_batch, and which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Full architecture description (exact public-literature config)."""

    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int              # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                   # dense FFN hidden (per-expert hidden for MoE)
    vocab_size: int

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1          # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25

    # --- attention details ---
    qk_norm: bool = False
    sliding_window: int = 0     # 0 = full attention
    rope_theta: float = 10_000.0
    causal: bool = True         # False for encoder-only

    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_num_groups: int = 1
    attn_every: int = 0         # hybrid: 1 attention layer per `attn_every`
                                #  (jamba: 8 → 1:7 attn:mamba interleave)

    # --- modality frontend (stub: input_specs provides embeddings) ---
    frontend: str = "none"      # none | vision | audio
    frontend_dim: int = 0       # embedding dim the stub provides
    frontend_tokens: int = 0    # prefix tokens contributed by the frontend

    # --- capabilities ---
    decode_supported: bool = True
    subquadratic: bool = False  # may run long_500k
    tie_embeddings: bool = False

    # --- FFN kind ---
    mlp_kind: str = "swiglu"    # swiglu (3 matrices) | gelu (2 matrices)

    # --- training knobs ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ---------------------------------------------------------------
    def __post_init__(self) -> None:
        if self.family in ("moe",) and not self.num_experts:
            raise ValueError(f"{self.name}: moe family requires num_experts")
        if self.num_heads and self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads must be divisible by num_kv_heads")
        if self.attn_every and self.num_layers % self.attn_every:
            raise ValueError(f"{self.name}: num_layers must divide by attn_every")

    # --- derived dims ---
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' — which mixer a layer uses."""
        if self.family == "ssm":
            return "ssm"
        if self.attn_every:
            # jamba-style: attention at position (attn_every//2) of each period
            return "attn" if (layer_idx % self.attn_every) == self.attn_every // 2 else "ssm"
        return "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        return bool(self.num_experts) and (layer_idx % self.moe_every == self.moe_every - 1)

    # --- parameter counts (for roofline MODEL_FLOPS) ---
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, excluding biases."""
        d = self.d_model
        n = 0
        # embeddings (+ untied LM head)
        if self.vocab_size:
            n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend_dim:
            n += self.frontend_dim * d  # frontend projection
        for layer in range(self.num_layers):
            kind = self.layer_kind(layer)
            if kind == "attn":
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            else:  # ssm (mamba2)
                di, ns, g = self.ssm_d_inner, self.ssm_state, self.ssm_num_groups
                # in_proj → [z, x, B, C, dt] ; out_proj
                n += d * (2 * di + 2 * g * ns + self.ssm_num_heads) + di * d
                n += self.ssm_conv_width * (di + 2 * g * ns)  # depthwise conv
            mats = 3 if self.mlp_kind == "swiglu" else 2
            if self.layer_is_moe(layer):
                e = self.experts_per_token if active_only else self.num_experts
                n += e * mats * d * self.d_ff
                n += d * self.num_experts  # router (always dense)
            elif self.d_ff:
                n += mats * d * self.d_ff
        return n

    def model_flops_per_token(self, training: bool = True) -> float:
        """6·N·D convention (2·N forward, 4·N backward) per token; N active."""
        n_active = self.param_count(active_only=True)
        return (6.0 if training else 2.0) * n_active

    # --- shape applicability (DESIGN.md §5 skip rules) ---
    def shape_supported(self, shape: ShapeSpec) -> tuple[bool, str]:
        """(supported, reason_if_not)."""
        if shape.kind == "decode" and not self.decode_supported:
            return False, f"{self.name} is encoder-only: no decode step"
        if shape.name == "long_500k" and not self.subquadratic:
            return False, (
                f"{self.name} uses full quadratic attention: 524k context "
                "unsupported (see DESIGN.md §5)"
            )
        return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_REDUCED: dict[str, Callable[[], ArchConfig]] = {}


def register(full: Callable[[], ArchConfig], reduced: Callable[[], ArchConfig]) -> None:
    cfg = full()
    _REGISTRY[cfg.name] = full
    _REDUCED[cfg.name] = reduced


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
