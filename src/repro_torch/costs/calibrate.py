"""Roofline calibration: FLOPs/bytes → latency, energy, and WorkloadItems
(port of ``repro.costs.calibrate``).

This is the bridge between the model zoo's analytical operation counts
(:mod:`repro_torch.costs.counts`) and the paper's phase representation
(:class:`repro_torch.core.phases.WorkloadItem`): an :class:`AcceleratorProfile`
turns a :class:`~repro.costs.counts.RequestCounts` into the four phases the
energy simulator consumes —

    configuration    = weight load over the host link (+ fixed bring-up)
                       — the ML-accelerator analogue of the paper's
                       bitstream-loading phase
    data_loading     = request input over the host link
    inference        = roofline time  max(FLOPs/peak, bytes/BW) / efficiency
    data_offloading  = generated tokens back over the host link

so every downstream layer (scalar closed forms, fleet scan, optimizer, MC
ensembles) prices real models without knowing anything changed.

``efficiency`` is the fraction of the roofline bound actually achieved
(MFU-style); :func:`measured_efficiency` derives it from kernel timings
(``launch.costs``' calibration section times the port's own kernels on the
card) so the cost layer can be *calibrated* rather than assumed.

The profiles are the reference's, number for number, so the cost zoo
prices every model as the reference does; they describe a TPU-class chip
and an edge accelerator, not the card the port runs on.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.phases import (
    CONFIGURATION,
    DATA_LOADING,
    DATA_OFFLOADING,
    INFERENCE,
    Phase,
    WorkloadItem,
)
from repro_torch.costs.counts import OpCounts, RequestCounts

__all__ = [
    "AcceleratorProfile",
    "TPU_V5E_LIKE",
    "EDGE_ACCEL",
    "PROFILES",
    "DEFAULT_EFFICIENCY",
    "roofline_time_ms",
    "request_item",
    "measured_efficiency",
]

#: The reference's TPU-class ceilings (``repro.launch.roofline``'s TPU v5e
#: per-chip constants), copied so the port imports nothing of the JAX
#: package.  They are the reference's assumption about a TPU, not the
#: card's: ``tpu-v5e-like`` keeps them so the zoo's numbers equal the
#: reference's.
PEAK_FLOPS_BF16 = 197e12      # FLOP/s
HBM_BW = 819e9                # B/s

#: Default achieved fraction of the roofline bound (MFU-style assumption
#: when no measured calibration is supplied).
DEFAULT_EFFICIENCY = 0.5


@dataclasses.dataclass(frozen=True)
class AcceleratorProfile:
    """One accelerator class: roofline ceilings + phase powers.

    Units follow the paper's simulator: power in mW, time in ms, energy in
    mJ.  ``peak_flops``/``hbm_bw``/``io_bw`` are per second (FLOP/s, B/s).
    """

    name: str
    peak_flops: float = PEAK_FLOPS_BF16   # FLOP/s (bf16)
    hbm_bw: float = HBM_BW                # B/s
    io_bw: float = 25e9                   # B/s host ↔ accelerator link
    busy_power_mw: float = 200_000.0      # while computing
    io_power_mw: float = 90_000.0         # during data load / offload
    config_power_mw: float = 120_000.0    # during weight load / bring-up
    idle_power_mw: float = 35_000.0       # resident, waiting
    config_fixed_ms: float = 500.0        # runtime bring-up beyond weight IO

    def __post_init__(self) -> None:
        for f in ("peak_flops", "hbm_bw", "io_bw"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{self.name}: {f} must be positive")
        for f in ("busy_power_mw", "io_power_mw", "config_power_mw",
                  "idle_power_mw", "config_fixed_ms"):
            if getattr(self, f) < 0:
                raise ValueError(f"{self.name}: {f} must be non-negative")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: Datacenter inference chip (the reference's TPU-v5e-like ceilings above).
TPU_V5E_LIKE = AcceleratorProfile(name="tpu-v5e-like")

#: Battery-class edge accelerator (Mamba2-370M-scale nodes): two orders of
#: magnitude below the datacenter chip on every ceiling and power rail.
EDGE_ACCEL = AcceleratorProfile(
    name="edge-accel",
    peak_flops=2e12,
    hbm_bw=60e9,
    io_bw=2e9,
    busy_power_mw=4_000.0,
    io_power_mw=1_500.0,
    config_power_mw=2_500.0,
    idle_power_mw=150.0,
    config_fixed_ms=120.0,
)

PROFILES: dict[str, AcceleratorProfile] = {
    p.name: p for p in (TPU_V5E_LIKE, EDGE_ACCEL)
}


def roofline_time_ms(
    counts: OpCounts, profile: AcceleratorProfile, efficiency: float = 1.0
) -> float:
    """Roofline lower bound, de-rated by the achieved-efficiency fraction."""
    if not (0.0 < efficiency <= 1.0):
        raise ValueError(f"efficiency must be in (0, 1], got {efficiency}")
    bound_s = max(counts.flops / profile.peak_flops,
                  counts.hbm_bytes / profile.hbm_bw)
    return bound_s * 1e3 / efficiency


def request_item(
    counts: RequestCounts,
    profile: AcceleratorProfile,
    efficiency: float = DEFAULT_EFFICIENCY,
) -> WorkloadItem:
    """A :class:`WorkloadItem` pricing one inference request of this model
    on this accelerator — directly consumable by every simulator layer."""
    config_ms = profile.config_fixed_ms + counts.weight_bytes / profile.io_bw * 1e3
    load_ms = counts.input_bytes / profile.io_bw * 1e3
    infer_ms = roofline_time_ms(counts.total, profile, efficiency)
    offload_ms = counts.output_bytes / profile.io_bw * 1e3
    return WorkloadItem(
        name=f"{counts.model}@{profile.name}"
             f"[b{counts.batch},p{counts.prefill_len},d{counts.decode_len}]",
        phases=(
            Phase(CONFIGURATION, profile.config_power_mw, config_ms),
            Phase(DATA_LOADING, profile.io_power_mw, load_ms),
            Phase(INFERENCE, profile.busy_power_mw, infer_ms),
            Phase(DATA_OFFLOADING, profile.io_power_mw, offload_ms),
        ),
        idle_power_mw=profile.idle_power_mw,
    )


def measured_efficiency(
    analytic: dict[str, OpCounts],
    measured_us: dict[str, float],
    peak_flops: float,
    hbm_bw: float,
) -> dict[str, float]:
    """Achieved fraction of the roofline bound per kernel.

    ``analytic`` maps kernel name → its :class:`OpCounts` at the measured
    shape; ``measured_us`` maps the same names → measured microseconds (e.g.
    from ``launch.costs``' calibration section).  Returns name →
    ``bound_us / measured_us`` clipped to (0, 1] — a kernel at the roofline
    scores 1.0.  Kernels missing from either side are skipped.
    """
    out = {}
    for name, c in analytic.items():
        us = measured_us.get(name)
        if us is None or us <= 0:
            continue
        bound_us = max(c.flops / peak_flops, c.hbm_bytes / hbm_bw) * 1e6
        out[name] = min(max(bound_us / us, 1e-9), 1.0)
    return out
