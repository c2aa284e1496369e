"""Phase model for duty-cycled accelerator workloads (paper §1–§2); a
copy of ``repro.core.phases`` for the port.

A *workload item* is the sequence of phases an accelerator executes in
response to one inference request: configuration (Setup + Bitstream
Loading), data loading, inference, data offloading.  Each phase is
characterized by average power (mW) and duration (ms) — exactly the
representation the paper's simulator consumes (Table 2).

Units used throughout ``repro_torch.core``:
    power  : milliwatts (mW)
    time   : milliseconds (ms)
    energy : millijoules (mJ)   (mW * ms = µJ; we divide by 1000)

These are the paper's own units; keeping them avoids unit-conversion bugs
when validating against the paper's tables.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping


def energy_mj(power_mw: float, time_ms: float) -> float:
    """Energy in mJ of a phase at ``power_mw`` for ``time_ms``."""
    return power_mw * time_ms / 1000.0


@dataclasses.dataclass(frozen=True)
class Phase:
    """One phase of a workload item: average power (mW) over a duration (ms)."""

    name: str
    power_mw: float
    time_ms: float

    def __post_init__(self) -> None:
        if self.power_mw < 0:
            raise ValueError(f"phase {self.name!r}: negative power {self.power_mw}")
        if self.time_ms < 0:
            raise ValueError(f"phase {self.name!r}: negative time {self.time_ms}")

    @property
    def energy_mj(self) -> float:
        return energy_mj(self.power_mw, self.time_ms)

    def to_dict(self) -> dict:
        return {"name": self.name, "power_mw": self.power_mw, "time_ms": self.time_ms}

    @staticmethod
    def from_dict(d: Mapping) -> "Phase":
        return Phase(str(d["name"]), float(d["power_mw"]), float(d["time_ms"]))


# Canonical phase names (paper Fig. 2 / Table 2).
CONFIGURATION = "configuration"
DATA_LOADING = "data_loading"
INFERENCE = "inference"
DATA_OFFLOADING = "data_offloading"
IDLE = "idle_waiting"

#: Phases that constitute the *execution* part of a workload item (everything
#: except configuration).  Under the Idle-Waiting strategy these are the only
#: phases paid per item.
EXECUTION_PHASES = (DATA_LOADING, INFERENCE, DATA_OFFLOADING)


@dataclasses.dataclass(frozen=True)
class WorkloadItem:
    """A full workload item: ordered phases + idle power of the accelerator.

    ``phases`` must include a ``configuration`` phase for strategies that
    reconfigure (On-Off); Idle-Waiting skips it per item (paper §4.2).
    ``idle_power_mw`` is the accelerator's power while idle-waiting
    (strategy/power-method dependent — see :mod:`repro_torch.core.strategies`).
    """

    name: str
    phases: tuple[Phase, ...]
    idle_power_mw: float

    def phase(self, name: str) -> Phase:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(f"workload item {self.name!r} has no phase {name!r}")

    def has_phase(self, name: str) -> bool:
        return any(p.name == name for p in self.phases)

    # ---- per-item aggregates -------------------------------------------------
    @property
    def config_energy_mj(self) -> float:
        return self.phase(CONFIGURATION).energy_mj if self.has_phase(CONFIGURATION) else 0.0

    @property
    def config_time_ms(self) -> float:
        return self.phase(CONFIGURATION).time_ms if self.has_phase(CONFIGURATION) else 0.0

    @property
    def execution_energy_mj(self) -> float:
        """Energy of everything except configuration (paper: 'all
        configuration-related overheads are zero' for Idle-Waiting items)."""
        return sum(p.energy_mj for p in self.phases if p.name != CONFIGURATION)

    @property
    def execution_time_ms(self) -> float:
        return sum(p.time_ms for p in self.phases if p.name != CONFIGURATION)

    @property
    def total_energy_mj(self) -> float:
        return sum(p.energy_mj for p in self.phases)

    @property
    def total_time_ms(self) -> float:
        """T_latency including configuration (On-Off strategy latency)."""
        return sum(p.time_ms for p in self.phases)

    def config_fraction(self) -> float:
        """Fraction of per-item energy spent in the configuration phase
        (the paper's prior work measured 87.15% before optimization)."""
        tot = self.total_energy_mj
        return self.config_energy_mj / tot if tot else 0.0

    def with_phase(self, phase: Phase) -> "WorkloadItem":
        """This item with ``phase`` substituted for its same-named phase
        (prepended when absent — configuration leads by convention).

        >>> item = paper_lstm_item().with_phase(Phase(CONFIGURATION, 327.9, 36.145))
        >>> round(item.config_energy_mj, 2)
        11.85
        """
        if self.has_phase(phase.name):
            phases = tuple(phase if p.name == phase.name else p for p in self.phases)
        else:
            phases = (phase,) + self.phases
        return dataclasses.replace(self, phases=phases)

    # ---- (de)serialization (YAML-friendly dicts) -----------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "idle_power_mw": self.idle_power_mw,
            "phases": [p.to_dict() for p in self.phases],
        }

    @staticmethod
    def from_dict(d: Mapping) -> "WorkloadItem":
        return WorkloadItem(
            name=str(d["name"]),
            phases=tuple(Phase.from_dict(p) for p in d["phases"]),
            idle_power_mw=float(d["idle_power_mw"]),
        )

    @staticmethod
    def from_table(
        name: str,
        rows: Iterable[tuple[str, float, float]],
        idle_power_mw: float,
    ) -> "WorkloadItem":
        """Build from (phase_name, power_mw, time_ms) rows — Table 2 style."""
        return WorkloadItem(
            name=name,
            phases=tuple(Phase(n, p, t) for (n, p, t) in rows),
            idle_power_mw=idle_power_mw,
        )


# ---------------------------------------------------------------------------
# The paper's measured LSTM accelerator workload item (Table 2), using the
# optimal configuration settings from Experiment 1.
# ---------------------------------------------------------------------------
PAPER_LSTM_TABLE2 = (
    (CONFIGURATION, 327.9, 36.145),
    (DATA_LOADING, 138.7, 0.0100),
    (INFERENCE, 171.4, 0.0281),  # includes 114 mW clock-ref + flash (Table 2 note)
    (DATA_OFFLOADING, 144.1, 0.0020),
)

#: Idle power of the baseline Idle-Waiting strategy (Table 2 / Table 3).
PAPER_IDLE_POWER_BASELINE_MW = 134.3


def paper_lstm_item(idle_power_mw: float = PAPER_IDLE_POWER_BASELINE_MW) -> WorkloadItem:
    """The paper's LSTM-accelerator workload item (Table 2)."""
    return WorkloadItem.from_table("lstm_accelerator_h20", PAPER_LSTM_TABLE2, idle_power_mw)
