"""Serving engine: prefill + batched decode (port of
``repro.serving.engine``).

The engine is the ``infer``/``bring_up``/``release`` provider for the
duty-cycle controller: ``bring_up_from_checkpoint`` restores the weights
from a (compressed) checkpoint onto the card; ``release`` drops every
device buffer and hands the memory back to CUDA.  Every phase ends in a
device synchronize before the host clock is read, so the controller
measures run time, not launch time.  An optional
:class:`repro_torch.obs.metrics.MetricsRegistry` (``metrics=``) records
the reference's counters, gauges and latency histograms at the same
moments; ``None`` (the default) leaves the hot path as it is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import model_zoo as zoo
from repro_torch.obs.metrics import default_latency_edges_ms


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor             # (B, n_new) int32
    prefill_s: float
    decode_s: float

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        max_len: int,
        metrics: Optional[Any] = None,
    ):
        if not cfg.decode_supported:
            raise ValueError(f"{cfg.name} is encoder-only")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = params["embed"].device
        # optional repro_torch.obs.metrics.MetricsRegistry — when present,
        # the engine records generate/release/bring-up counters and latency
        # histograms; None keeps the hot path untouched
        self.metrics = metrics

    @torch.inference_mode()
    def generate(
        self, batch: dict, n_new: int, greedy: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> GenerationResult:
        """Prefill, then ``n_new`` decode steps; greedy unless ``greedy`` is
        False and a ``generator`` (on the engine's device) is given."""
        if self.params is None:
            raise RuntimeError(
                "engine was released (powered off); bring up from a "
                "checkpoint before generating"
            )
        t0 = time.perf_counter()
        logits, state = zoo.prefill_fn(self.params, batch, self.cfg, self.max_len)
        synchronize(self.device)
        t1 = time.perf_counter()
        outs = []
        tok = torch.argmax(logits, -1).to(torch.int32)
        for _ in range(n_new):
            outs.append(tok)
            logits, state = zoo.decode_fn(self.params, state, tok, self.cfg)
            if greedy or generator is None:
                tok = torch.argmax(logits, -1).to(torch.int32)
            else:
                probs = torch.softmax(logits, -1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
        tokens = torch.stack(outs, dim=1)
        synchronize(self.device)
        t2 = time.perf_counter()
        result = GenerationResult(tokens=tokens, prefill_s=t1 - t0, decode_s=t2 - t1)
        if self.metrics is not None:
            self.metrics.counter("engine_generate_calls").inc()
            self.metrics.counter("engine_tokens_generated").inc(int(tokens.shape[0]) * n_new)
            edges = default_latency_edges_ms()
            self.metrics.histogram("engine_prefill_ms", edges).observe(1000.0 * result.prefill_s)
            self.metrics.histogram("engine_decode_ms", edges).observe(1000.0 * result.decode_s)
        return result

    @property
    def resident(self) -> bool:
        """Whether weights are on device (idle-waiting) or dropped (off)."""
        return self.params is not None

    def param_bytes(self) -> int:
        """Resident footprint of the weights."""
        if self.params is None:
            return 0
        return sum(t.numel() * t.element_size() for _, t in flatten(self.params))

    def release(self) -> None:
        """Drop device buffers (the On-Off 'power-off') and hand the cached
        blocks back to CUDA, so the memory is free as after
        ``leaf.delete()`` in the reference."""
        if self.params is None:
            return
        self.params = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.metrics is not None:
            self.metrics.counter("engine_releases").inc()
            self.metrics.gauge("engine_resident").set(0)


def bring_up_from_checkpoint(
    cfg: ArchConfig,
    manager: CheckpointManager,
    max_len: int,
    warmup_batch: Optional[dict] = None,
    device="cuda",
    dtype=torch.bfloat16,
    metrics: Optional[Any] = None,
) -> ServingEngine:
    """The 'configuration phase': restore (decompress + dequantize) the
    weights onto ``device`` and build the engine (+ an optional warm-up
    generation).  With ``metrics``, the bring-up is counted and its time
    (restore through warm-up, after a device synchronize) observed."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    target = zoo.param_shapes(cfg, dtype)
    _, params = manager.restore_latest(target, device=device)
    if params is None:
        raise FileNotFoundError(f"no checkpoint in {manager.directory}")
    synchronize(device)
    engine = ServingEngine(cfg, params, max_len, metrics=metrics)
    if warmup_batch is not None:
        engine.generate(warmup_batch, n_new=1)
    if metrics is not None:
        metrics.counter("engine_bring_ups").inc()
        metrics.gauge("engine_resident").set(1)
        metrics.histogram("engine_bring_up_ms", default_latency_edges_ms()).observe(
            1000.0 * (time.perf_counter() - t0)
        )
    return engine
