"""Performance knobs (port of ``repro.configs.perf``).

Defaults are the reference's baseline.  The training levers act here:
``num_microbatches``, ``remat`` (``full | dots | none``),
``optimizer_moment_dtype``, ``loss_chunk`` and ``ssd_chunk`` (also read by
the single-device prefill of the Mamba-2 layers).  The train step on a mesh
of ranks (``training/train_loop.py``) reads ``gather_weights_once``
(gather the FSDP blocks once a step, not at each use) and
``grad_compress_pod`` (the compressed cross-pod branch, with
``launch.dryrun_lib.perf_rules``); on one device both do nothing.  The
sharded prefill and decode (``model_zoo.prefill_fn`` / ``decode_fn`` with
``mesh=``) read ``gather_weights_once`` (every block gathered once a call)
and refuse ``shard_cache_seq_over_model`` and
``shard_long_cache_over_model`` (a cache split over its sequence waits for
a later slice, ROADMAP; ``perf_rules`` maps both into the rule table and
``dryrun_lib.batch_pspecs`` raises for them).  Still read by nothing:
``seq_parallel_residual`` (the sequence-parallel residual, ROADMAP) and
``moe_capacity_factor`` (the reference's ``moe_block`` ignores it without
a mesh; ``models.moe.moe_block`` on a mesh of ranks takes its capacity
factor as an argument).

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
