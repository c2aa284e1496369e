"""TPU-pod adaptation of the paper's phase/energy model (a pure-Python copy
of ``repro.core.tpu_energy``).

Maps the FPGA concepts onto a v5e serving slice:

    configuration phase  = runtime bring-up (Setup floor: program load /
                           executable deserialization) + weight loading
                           (Bitstream Loading: host→HBM transfer)
    tunable parameters   = DMA lanes {1,2,4} × host-link tier {0.5,1,2}
                           × checkpoint compression {none, zstd, zstd+int8}
                           (mirrors Table 1: buswidth × clock × compression)
    idle power tiers     = baseline / clock-gated links (Method 1) /
                           retention state (Method 2; simulated — TPUs do
                           not expose DVFS, exactly as the paper's hardware
                           did not support dynamic voltage scaling)

Power constants are per-chip engineering estimates (public TDP-class
numbers; all configurable) — the *structure* of the analysis is the
paper's.  They describe a TPU slice, as in the reference, not the card the
port runs on.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core import energy_model as em
from repro_torch.core.phases import (
    CONFIGURATION,
    DATA_LOADING,
    DATA_OFFLOADING,
    INFERENCE,
    Phase,
    WorkloadItem,
)

# --- per-chip power model (watts; configurable estimates) ---
P_ACTIVE_W = 200.0            # sustained inference
P_IDLE_BASELINE_W = 65.0      # HBM refresh + clocks + parked links
P_IDLE_GATED_W = 35.0         # Method-1 analogue: ICI/host links gated
P_IDLE_RETENTION_W = 12.0     # Method-2 analogue: retention state (simulated)
P_LOAD_W = 90.0               # during weight DMA (links active, MXU idle)
P_LOAD_DECOMP_EXTRA_W = 25.0  # extra while dequant/zstd decode kernels run

#: bring-up floor: runtime init + compiled-program load (the 'Setup' stage —
#: model-dependent, irreducible; paper's Spartan-7 floor was 27 ms).
SETUP_TIME_MS = 2000.0
SETUP_POWER_W = 70.0

#: host→HBM effective bandwidth per DMA lane (bytes/s) at link tier 1.0
LANE_BW = 8e9

DMA_LANES = (1, 2, 4)
LINK_TIERS = (0.5, 1.0, 2.0)
COMPRESSION = ("none", "zstd", "zstd+int8")

#: compressed-size ratio and on-device decode overhead factor per mode
COMPRESSION_RATIO = {"none": 1.0, "zstd": 0.62, "zstd+int8": 0.28}
COMPRESSION_TIME_OVERHEAD = {"none": 1.0, "zstd": 1.08, "zstd+int8": 1.12}


@dataclasses.dataclass(frozen=True)
class TpuConfigParams:
    """One point of the bring-up parameter space (Table-1 analogue)."""

    lanes: int = 1
    link_tier: float = 1.0
    compression: str = "none"

    def __post_init__(self):
        assert self.lanes in DMA_LANES
        assert self.link_tier in LINK_TIERS
        assert self.compression in COMPRESSION


TPU_WORST = TpuConfigParams(1, 0.5, "none")
TPU_BEST = TpuConfigParams(4, 2.0, "zstd+int8")


@dataclasses.dataclass(frozen=True)
class TpuCell:
    """Energy-model inputs for one (arch × shape) serving cell."""

    arch: str
    chips: int
    param_bytes: float            # total weights (bf16)
    infer_time_ms: float          # per-request step time (roofline bound)

    # ---- configuration phase -------------------------------------------
    def load_time_ms(self, p: TpuConfigParams) -> float:
        bw = p.lanes * p.link_tier * LANE_BW * self.chips   # parallel per-chip DMA
        bytes_moved = self.param_bytes * COMPRESSION_RATIO[p.compression]
        return (
            bytes_moved / bw * 1000.0 * COMPRESSION_TIME_OVERHEAD[p.compression]
        )

    def load_power_mw(self, p: TpuConfigParams) -> float:
        w = P_LOAD_W + (P_LOAD_DECOMP_EXTRA_W if p.compression != "none" else 0.0)
        return w * 1000.0 * self.chips

    def config_time_ms(self, p: TpuConfigParams) -> float:
        return SETUP_TIME_MS + self.load_time_ms(p)

    def config_energy_mj(self, p: TpuConfigParams) -> float:
        setup = SETUP_POWER_W * 1000.0 * self.chips * SETUP_TIME_MS / 1000.0
        load = self.load_power_mw(p) * self.load_time_ms(p) / 1000.0
        return setup + load

    # ---- workload item ---------------------------------------------------
    def workload_item(
        self, p: TpuConfigParams, idle_tier: str = "baseline"
    ) -> WorkloadItem:
        idle_w = {
            "baseline": P_IDLE_BASELINE_W,
            "method1": P_IDLE_GATED_W,
            "method1+2": P_IDLE_RETENTION_W,
        }[idle_tier]
        cfg_t = self.config_time_ms(p)
        cfg_p = 1000.0 * self.config_energy_mj(p) / cfg_t
        return WorkloadItem(
            name=f"{self.arch}-tpu",
            phases=(
                Phase(CONFIGURATION, cfg_p, cfg_t),
                Phase(DATA_LOADING, P_LOAD_W * 1000 * self.chips, 0.05),
                Phase(INFERENCE, P_ACTIVE_W * 1000 * self.chips, self.infer_time_ms),
                Phase(DATA_OFFLOADING, P_LOAD_W * 1000 * self.chips, 0.02),
            ),
            idle_power_mw=idle_w * 1000.0 * self.chips,
        )


def cell_from_roofline(
    cfg: ArchConfig, chips: int, roofline: dict, arch: Optional[str] = None
) -> TpuCell:
    """Build a TpuCell from a dry-run roofline record (§Dry-run JSON)."""
    return TpuCell(
        arch=arch or cfg.name,
        chips=chips,
        param_bytes=2.0 * cfg.param_count(),           # bf16
        infer_time_ms=roofline["step_time_lower_bound_s"] * 1000.0,
    )


def sweep_config_space(cell: TpuCell) -> list[dict]:
    """Exhaustive Table-1-analogue sweep (18 points)."""
    out = []
    for lanes, tier, comp in itertools.product(DMA_LANES, LINK_TIERS, COMPRESSION):
        p = TpuConfigParams(lanes, tier, comp)
        out.append(
            {
                "lanes": lanes,
                "link_tier": tier,
                "compression": comp,
                "config_time_ms": cell.config_time_ms(p),
                "config_energy_mj": cell.config_energy_mj(p),
            }
        )
    return out


def crossover_ms(
    cell: TpuCell,
    p: TpuConfigParams = TPU_BEST,
    idle_tier: str = "baseline",
) -> float:
    """Request period below which Idle-Waiting beats On-Off for this cell."""
    return em.crossover_period_ms(cell.workload_item(p, idle_tier))


def energy_reduction_factor(cell: TpuCell) -> float:
    sweep = sweep_config_space(cell)
    es = [s["config_energy_mj"] for s in sweep]
    return max(es) / min(es)
