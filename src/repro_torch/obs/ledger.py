"""Phase-resolved energy ledger: *where* the joules go (a copy of
``repro.obs.ledger`` for the port, without its JAX pytree registration).

The paper's argument is per-phase accounting — configuration vs. compute
vs. idle vs. off (the 40.13× configuration-energy reduction and the
499.06 ms Idle-Waiting crossover are both statements about individual
rows of that ledger) — yet most simulation results reduce to end-of-run
scalars.  :class:`EnergyLedger` is the shared five-axis breakdown every
numeric subsystem now reports:

    configure   configuration phases (initial bring-up + reconfigurations)
    compute     execution phases (data loading, inference, offloading, …)
    idle        idle-waiting residency between requests
    off         powered off (identically zero by definition — kept as an
                explicit axis so "off costs nothing" is an audited claim,
                not an omission)
    overhead    calibrated reconfiguration/power-up overhead (DESIGN.md §2),
                reported separately instead of folded into ``configure``

The hard contract — held by the reference's ``tests/test_obs.py`` and by
the port's ``tests/test_torch_core_sim.py`` — is **conservation**: the
axes of a ledger sum to the closed-form / simulated total energy within
1e-9 relative, so observability doubles as a correctness audit of every
kernel's internal accounting.

Leaves may be Python floats or NumPy float64 arrays of any matching
shape: a scalar simulation carries a 0-d ledger, a fleet carries ``(N,)``,
a Monte Carlo ensemble ``(S,)``.

The paper's headline ≈40.13× configuration-energy reduction (calibrated
model: 40.12×, within 0.5%) is literally a ratio of two ``configure``
rows — the Spartan-7 worst (1-bit bus @ 3 MHz, uncompressed) vs. best
(4-bit bus @ 66 MHz, compressed) bitstream-load settings:

>>> from repro_torch.core.adaptive import StaticPolicy
>>> from repro_torch.core.config_phase import (
...     SPARTAN7_XC7S15, BEST_PARAMS, WORST_PARAMS)
>>> from repro_torch.core.phases import paper_lstm_item
>>> from repro_torch.core.simulator import simulate_trace
>>> def configure_row_mj(params):
...     item = paper_lstm_item().with_phase(
...         SPARTAN7_XC7S15.config_phase(params))
...     res = simulate_trace(item, [0.0], StaticPolicy("on_off", item))
...     return float(res.ledger.configure_mj)
>>> ratio = configure_row_mj(WORST_PARAMS) / configure_row_mj(BEST_PARAMS)
>>> round(ratio, 2)
40.12
>>> abs(ratio - 40.13) / 40.13 < 0.005
True
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from repro_torch.core.phases import CONFIGURATION, IDLE

__all__ = [
    "AXES",
    "PHASE_TO_AXIS",
    "EnergyLedger",
    "axis_of_phase",
    "ledger_from_rollout",
]

#: Canonical ledger axes, in reporting order.
AXES = ("configure", "compute", "idle", "off", "overhead")

#: Simulator phase-key → ledger axis.  Anything not listed (the execution
#: phases, including model-zoo phase names) charges to ``compute``.
PHASE_TO_AXIS = {
    CONFIGURATION: "configure",
    "initial_configuration": "configure",
    IDLE: "idle",
    "off": "off",
    "powerup": "overhead",
    "initial_powerup": "overhead",
    "reconfig_overhead": "overhead",
}


def axis_of_phase(phase: str) -> str:
    """Ledger axis a simulator phase key charges to (default: compute)."""
    return PHASE_TO_AXIS.get(phase, "compute")


def _tolist(x):
    a = np.asarray(x, dtype=np.float64)
    return float(a) if a.ndim == 0 else a.tolist()


@dataclasses.dataclass(frozen=True)
class EnergyLedger:
    """Five-axis phase-resolved energy breakdown (mJ per axis).

    >>> led = EnergyLedger(configure_mj=11.85, compute_mj=2.0,
    ...                    idle_mj=1.0, off_mj=0.0, overhead_mj=0.0)
    >>> round(led.total_mj, 2)
    14.85
    >>> led.conservation_error(14.85) < 1e-12
    True
    """

    configure_mj: object
    compute_mj: object
    idle_mj: object
    off_mj: object
    overhead_mj: object

    # ---- construction --------------------------------------------------------
    @staticmethod
    def zeros(shape=()) -> "EnergyLedger":
        z = np.zeros(shape, dtype=np.float64)
        return EnergyLedger(*(z.copy() for _ in AXES))

    @staticmethod
    def from_axes(**axes) -> "EnergyLedger":
        """Build from ``axis=value`` pairs; missing axes default to 0."""
        unknown = set(axes) - set(AXES)
        if unknown:
            raise ValueError(f"unknown ledger axes {sorted(unknown)}; valid: {AXES}")
        vals = {a: np.asarray(axes.get(a, 0.0), dtype=np.float64) for a in AXES}
        shape = np.broadcast_shapes(*(v.shape for v in vals.values()))
        return EnergyLedger(
            **{f"{a}_mj": np.broadcast_to(vals[a], shape).copy() for a in AXES}
        )

    @staticmethod
    def from_phase_dict(by_phase: Mapping[str, float]) -> "EnergyLedger":
        """Fold a simulator ``energy_by_phase_mj`` dict onto the five axes.

        >>> led = EnergyLedger.from_phase_dict(
        ...     {"initial_configuration": 11.85, "inference": 3.0,
        ...      "data_loading": 1.0, "idle_waiting": 2.0, "powerup": 0.5})
        >>> round(float(led.configure_mj), 2), round(float(led.compute_mj), 2)
        (11.85, 4.0)
        >>> round(float(led.overhead_mj), 2), float(led.off_mj)
        (0.5, 0.0)
        """
        acc = {a: 0.0 for a in AXES}
        for phase, mj in by_phase.items():
            acc[axis_of_phase(phase)] += float(mj)
        return EnergyLedger(**{f"{a}_mj": acc[a] for a in AXES})

    # ---- views ----------------------------------------------------------------
    def axes(self) -> dict[str, np.ndarray]:
        """``{axis: float64 array}`` view of the five axes."""
        return {a: np.asarray(getattr(self, f"{a}_mj"), dtype=np.float64)
                for a in AXES}

    @property
    def total_mj(self):
        """Sum of the five axes, in fixed axis order (deterministic fp)."""
        ax = self.axes()
        total = ax[AXES[0]]
        for a in AXES[1:]:
            total = total + ax[a]
        return float(total) if np.ndim(total) == 0 else total

    def aggregate(self) -> "EnergyLedger":
        """Device/seed-summed ledger: each axis reduced to a scalar."""
        return EnergyLedger(
            **{f"{a}_mj": float(np.sum(v)) for a, v in self.axes().items()}
        )

    def fractions(self) -> dict[str, float]:
        """Aggregated per-axis energy share (0 when the total is 0)."""
        agg = self.aggregate()
        total = agg.total_mj
        return {
            a: (float(getattr(agg, f"{a}_mj")) / total if total else 0.0)
            for a in AXES
        }

    def __add__(self, other: "EnergyLedger") -> "EnergyLedger":
        mine, theirs = self.axes(), other.axes()
        for a in AXES:
            if mine[a].shape != theirs[a].shape:
                raise ValueError(
                    f"cannot add ledgers with mismatched shapes on axis "
                    f"{a!r}: {mine[a].shape} vs {theirs[a].shape} — "
                    "broadcasting would multiply-count the smaller ledger; "
                    "aggregate() both sides first"
                )
        return EnergyLedger(**{f"{a}_mj": mine[a] + theirs[a] for a in AXES})

    # ---- the conservation contract ---------------------------------------------
    def conservation_error(self, total_mj) -> float:
        """Worst relative |axes sum − total| across all ledger entries.

        The denominator is ``max(1, |total|)`` — the same normalization the
        simulators' admission epsilon uses — so tiny totals don't inflate
        the error into false alarms.
        """
        total = np.asarray(total_mj, dtype=np.float64)
        mine = np.asarray(self.total_mj, dtype=np.float64)
        err = np.abs(mine - total) / np.maximum(1.0, np.abs(total))
        return float(np.max(err)) if err.size else 0.0

    def assert_conserves(self, total_mj, rtol: float = 1e-9) -> float:
        """Raise ``AssertionError`` unless the axes sum to ``total_mj``
        within ``rtol`` relative; returns the measured error for reporting."""
        err = self.conservation_error(total_mj)
        if not (err <= rtol) or not math.isfinite(err):
            raise AssertionError(
                f"ledger conservation violated: axes sum differs from the "
                f"total by {err:.3e} relative (tolerance {rtol:.0e})"
            )
        return err

    # ---- serialization ----------------------------------------------------------
    def to_dict(self, aggregate: bool = True) -> dict:
        """JSON-friendly dict: per-axis mJ (+ total and fractions).

        With ``aggregate=True`` (default) array-valued ledgers are summed
        over devices/seeds first; pass ``False`` to keep full arrays.
        """
        led = self.aggregate() if aggregate else self
        out = {f"{a}_mj": _tolist(getattr(led, f"{a}_mj")) for a in AXES}
        out["total_mj"] = _tolist(led.total_mj)
        out["fractions"] = self.fractions()
        return out


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def ledger_from_rollout(out: Mapping, consts: Mapping) -> EnergyLedger:
    """Ledger of a :func:`repro_torch.policy.rollout.rollout` output batch.

    ``out`` is the rollout result dict (per-stream tensors, on any device);
    ``consts`` is the :func:`repro_torch.policy.rollout.make_consts` dict.
    Every configuration event charged ``e_config`` splits into its pure
    configuration energy and the calibrated power-up overhead.
    """
    configs = _host(out["configurations"])
    n = _host(out["n_items"])
    ovh = float(consts.get("e_overhead", 0.0))
    cfg_pure = float(consts["e_config"]) - ovh
    return EnergyLedger.from_axes(
        configure=configs * cfg_pure,
        compute=n * float(consts["e_exec"]),
        idle=_host(out["idle_energy_mj"]),
        off=np.zeros_like(n),
        overhead=configs * ovh,
    )
