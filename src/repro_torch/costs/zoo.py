"""Per-model request costs: the model zoo priced for the energy simulator
(port of ``repro.costs.zoo``).

One call turns a registered architecture name into everything the
analytics stack consumes:

>>> from repro_torch.costs import model_request_cost
>>> rc = model_request_cost("mixtral-8x7b", batch=8)
>>> rc.item.has_phase("configuration")
True
>>> round(rc.latency_ms / 1e3, 1)          # seconds per 8-request batch
8.9
>>> round(rc.crossover_ms / 1e3, 1)        # Idle-Waiting wins below this gap
23.4
>>> rc.profile
'tpu-v5e-like'

The zoo covers the 10 registered LM architectures (`repro_torch.configs`)
plus the paper's own LSTM accelerator.  The LSTM is the **zero-calibration
limit**: its request cost *is* the measured Table-2 item
(:func:`repro_torch.core.phases.paper_lstm_item`), bit-for-bit, so the
paper's golden numbers (499.06 ms crossover, 12.39× lifetime) survive the
fusion unchanged.

Fleet hand-off: :func:`model_device_spec` builds a
:class:`repro_torch.fleet.state.DeviceSpec` per model, and
:func:`model_mix_fleet` stacks a heterogeneous mix (e.g. Mixtral racks
next to Mamba2 edge nodes) into one
:class:`~repro_torch.fleet.state.FleetParams` on the card (or ``device``),
ready for ``run_periodic`` / ``run_routed`` / the MC ensembles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.paper_lstm import full as _paper_lstm_config
from repro_torch.core import energy_model as em
from repro_torch.core.phases import WorkloadItem, paper_lstm_item
from repro_torch.costs.calibrate import (
    DEFAULT_EFFICIENCY,
    EDGE_ACCEL,
    PROFILES,
    TPU_V5E_LIKE,
    AcceleratorProfile,
    request_item,
)
from repro_torch.costs.counts import RequestCounts, lstm_counts, request_counts

__all__ = [
    "PAPER_LSTM_MODEL",
    "RequestCost",
    "model_names",
    "default_profile",
    "model_request_cost",
    "model_workload_item",
    "model_device_spec",
    "model_mix_fleet",
]

#: Name of the paper's measured accelerator inside the cost zoo.
PAPER_LSTM_MODEL = "paper-lstm-h20"

#: Models at or below this many parameters default to the edge profile.
_EDGE_PARAM_LIMIT = 2_000_000_000


@dataclasses.dataclass(frozen=True)
class RequestCost:
    """A model's per-request cost on one accelerator profile.

    ``source`` is ``"roofline"`` for analytically derived items and
    ``"measured"`` for the paper's Table-2 LSTM (the zero-calibration
    limit, where ``item == paper_lstm_item()`` exactly).
    """

    model: str
    profile: str
    source: str                  # "roofline" | "measured"
    efficiency: float
    counts: RequestCounts
    item: WorkloadItem

    @property
    def latency_ms(self) -> float:
        """Per-request latency while resident (Idle-Waiting latency)."""
        return self.item.execution_time_ms

    @property
    def energy_mj(self) -> float:
        """Per-request energy while resident (execution phases)."""
        return self.item.execution_energy_mj

    @property
    def config_ms(self) -> float:
        return self.item.config_time_ms

    @property
    def config_mj(self) -> float:
        return self.item.config_energy_mj

    @property
    def crossover_ms(self) -> float:
        """Request period below which Idle-Waiting beats On-Off for this
        model (the paper's decision rule, per model)."""
        return em.crossover_period_ms(self.item)

    def to_dict(self) -> dict:
        return {
            "model": self.model,
            "profile": self.profile,
            "source": self.source,
            "efficiency": self.efficiency,
            **self.counts.to_dict(),
            "latency_ms": self.latency_ms,
            "energy_mj": self.energy_mj,
            "config_ms": self.config_ms,
            "config_mj": self.config_mj,
            "idle_power_mw": self.item.idle_power_mw,
            "crossover_ms": self.crossover_ms,
        }


def model_names() -> list[str]:
    """Every model the cost zoo prices (registered archs + paper LSTM)."""
    return [*list_archs(), PAPER_LSTM_MODEL]


def default_profile(model: str) -> AcceleratorProfile:
    """Datacenter profile for big models, edge profile for small ones."""
    if model == PAPER_LSTM_MODEL:
        return EDGE_ACCEL
    cfg = get_config(model)
    small = cfg.param_count(active_only=False) <= _EDGE_PARAM_LIMIT
    return EDGE_ACCEL if small else TPU_V5E_LIKE


def _resolve_profile(profile) -> AcceleratorProfile:
    if isinstance(profile, AcceleratorProfile):
        return profile
    if profile not in PROFILES:
        raise KeyError(
            f"unknown profile {profile!r}; available: {sorted(PROFILES)}"
        )
    return PROFILES[profile]


@functools.lru_cache(maxsize=512)
def _cached_cost(
    model: str, batch: int, prefill_len: int, decode_len: int,
    profile_name: Optional[str], efficiency: float,
) -> RequestCost:
    if model == PAPER_LSTM_MODEL:
        # Zero-calibration limit: the measured Table-2 item, bit-for-bit.
        lc = _paper_lstm_config()
        counts = RequestCounts(
            model=PAPER_LSTM_MODEL,
            batch=batch,
            prefill_len=lc.seq_len,
            decode_len=0,
            prefill=lstm_counts(batch, lc.seq_len, lc.input_dim, lc.hidden_size),
            decode=lstm_counts(batch, lc.seq_len, lc.input_dim, lc.hidden_size).scale(0.0),
            weight_bytes=4.0 * 4 * lc.hidden_size * (lc.input_dim + lc.hidden_size),
            input_bytes=4.0 * batch * lc.seq_len * lc.input_dim,
            output_bytes=4.0 * batch * lc.num_classes,
        )
        return RequestCost(
            model=PAPER_LSTM_MODEL,
            profile="paper-fpga-measured",
            source="measured",
            efficiency=1.0,
            counts=counts,
            item=paper_lstm_item(),
        )
    prof = _resolve_profile(profile_name) if profile_name else default_profile(model)
    cfg = get_config(model)
    counts = request_counts(cfg, batch=batch, prefill_len=prefill_len,
                            decode_len=decode_len)
    return RequestCost(
        model=model,
        profile=prof.name,
        source="roofline",
        efficiency=efficiency,
        counts=counts,
        item=request_item(counts, prof, efficiency),
    )


def model_request_cost(
    model: str,
    batch: int = 1,
    prefill_len: int = 2048,
    decode_len: int = 128,
    profile: Optional[AcceleratorProfile | str] = None,
    efficiency: float = DEFAULT_EFFICIENCY,
) -> RequestCost:
    """Roofline-calibrated cost of one request (``batch`` sequences,
    ``prefill_len`` prompt tokens, ``decode_len`` generated tokens)."""
    if model != PAPER_LSTM_MODEL and model not in list_archs():
        raise KeyError(
            f"unknown model {model!r}; available: {model_names()}"
        )
    prof_name = None
    if profile is not None:
        prof = _resolve_profile(profile)
        if prof.name not in PROFILES:
            # ad-hoc profile: bypass the cache
            cfg = get_config(model)
            counts = request_counts(cfg, batch=batch, prefill_len=prefill_len,
                                    decode_len=decode_len)
            return RequestCost(model=model, profile=prof.name, source="roofline",
                               efficiency=efficiency, counts=counts,
                               item=request_item(counts, prof, efficiency))
        prof_name = prof.name
    return _cached_cost(model, batch, prefill_len, decode_len, prof_name, efficiency)


def model_workload_item(model: str, **kwargs) -> WorkloadItem:
    """Shorthand: the :class:`WorkloadItem` of :func:`model_request_cost`."""
    return model_request_cost(model, **kwargs).item


def model_device_spec(
    model: str,
    strategy: str = "adaptive",
    request_period_ms: Optional[float] = None,
    utilization: float = 0.25,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
    **cost_kwargs,
):
    """A fleet :class:`~repro_torch.fleet.state.DeviceSpec` serving this model.

    When ``request_period_ms`` is omitted it defaults to
    ``latency / utilization`` — a device ``utilization``-busy with its own
    model's requests, guaranteed feasible for both strategies.
    """
    from repro_torch.fleet.state import DeviceSpec  # deferred: keep import DAG acyclic

    cost = model_request_cost(model, **cost_kwargs)
    if request_period_ms is None:
        if not (0.0 < utilization <= 1.0):
            raise ValueError(f"utilization must be in (0, 1], got {utilization}")
        request_period_ms = max(
            cost.item.execution_time_ms / utilization, cost.item.total_time_ms
        )
    return DeviceSpec(
        item=cost.item,
        strategy=strategy,
        request_period_ms=request_period_ms,
        e_budget_mj=e_budget_mj,
        powerup_overhead_mj=powerup_overhead_mj,
    )


def model_mix_fleet(
    models: Sequence[str | tuple[str, int]],
    n_devices: Optional[int] = None,
    device="cuda",
    **spec_kwargs,
):
    """Stack a heterogeneous model mix into one
    :class:`~repro_torch.fleet.state.FleetParams` on ``device`` (the card by
    default; ``"cpu"`` on the host).

    ``models`` is a list of names or ``(name, replicas)`` pairs; the
    resulting template is tiled cyclically up to ``n_devices`` when given.
    All other keyword arguments forward to :func:`model_device_spec`.
    """
    from repro_torch.fleet.state import FleetParams  # deferred: keep import DAG acyclic

    entries: list[tuple[str, int]] = []
    for m in models:
        name, reps = m if isinstance(m, tuple) else (m, 1)
        if reps < 1:
            raise ValueError(f"model {name!r}: replicas must be >= 1, got {reps}")
        entries.append((name, reps))
    if not entries:
        raise ValueError("model_mix_fleet needs at least one model")
    specs = []
    for name, reps in entries:
        specs.extend([model_device_spec(name, **spec_kwargs)] * reps)
    params = FleetParams.from_specs(specs, device)
    return params.tile(n_devices) if n_devices else params
