"""Performance knobs (port of ``repro.configs.perf``).

Defaults are the reference's baseline.  The training levers act here:
``num_microbatches``, ``remat`` (``full | dots | none``),
``optimizer_moment_dtype``, ``loss_chunk`` and ``ssd_chunk`` (also read by
the single-device prefill of the Mamba-2 layers).  The train step on a mesh
of ranks (``training/train_loop.py``, every family) reads
``gather_weights_once`` (gather the FSDP blocks once a step, not at each
use), ``grad_compress_pod`` (the compressed cross-pod branch, with
``launch.dryrun_lib.perf_rules``) and ``moe_capacity_factor`` (the MoE's
sharded bodies, as the reference's ``forward_block`` passes it to
``moe_block``; the config's factor when unset); on one device the first
two do nothing and the dropless dispatch reads no capacity.  The
serving step on a mesh of ranks (``model_zoo.prefill_fn`` / ``decode_fn``
/ ``encode_fn`` with ``mesh=``, every family) reads
``gather_weights_once`` (every block gathered once a call),
``moe_capacity_factor`` (the MoE's sharded bodies in the prefill and
decode, as the reference's serving passes it to ``moe_block``; the
config's factor when unset; one device runs the dropless dispatch and
reads none) and the two cache flags, which ``model_zoo.serving_layout``
applies to its rule table as ``perf_rules`` does:
``shard_cache_seq_over_model`` puts a KV cache's sequence (``cache_seq``)
on ``model`` in prefill and decode cells, ``shard_long_cache_over_model``
puts the long-context cache's (``long_cache_seq``, ``data`` by default)
there.  A split cache's decode combines each rank's partial attention
over its block (``models/attention.py``); no kernel changes for it.
Still read by nothing: ``seq_parallel_residual`` (the sequence-parallel
residual, ROADMAP).

The reference's kernel-choice fields (``attention_impl``, ``ssd_impl``,
``attn_scores_dtype``, ``attn_triangular``) are left out: on the card the
attention and the SSD always go through the hand-written kernels
(``kernels/*/ops.py``), so no setting may send a CUDA tensor to a plain
version, and passing one of them raises ``TypeError``.
"""
from __future__ import annotations

import dataclasses

REMAT_MODES = ("full", "dots", "none")
MOMENT_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    # training
    num_microbatches: int = 1          # grad-accum microbatches per step
    remat: str = "full"                # full | dots | none
    optimizer_moment_dtype: str = "float32"   # float32 | bfloat16
    grad_compress_pod: bool = False    # int8 cross-pod gradient all-reduce

    # sharding levers (ignored on one device)
    seq_parallel_residual: bool = False
    shard_long_cache_over_model: bool = False
    gather_weights_once: bool = False

    # sharding levers (serving)
    shard_cache_seq_over_model: bool = False

    # compute levers
    loss_chunk: int = 4096             # vocab-projection sequence chunk
    ssd_chunk: int = 128               # SSD chunk length
    moe_capacity_factor: float | None = None

    def __post_init__(self):
        if self.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {self.remat!r}")
        if self.optimizer_moment_dtype not in MOMENT_DTYPES:
            raise ValueError(
                f"optimizer_moment_dtype must be one of {MOMENT_DTYPES}, "
                f"got {self.optimizer_moment_dtype!r}"
            )
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be at least 1, got {self.num_microbatches}")
        if self.loss_chunk < 1:
            raise ValueError(f"loss_chunk must be at least 1, got {self.loss_chunk}")


BASELINE = PerfConfig()
