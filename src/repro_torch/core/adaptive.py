"""Adaptive power policy: choose/switch strategies from observed arrivals.
(A copy of ``repro.core.adaptive`` for the port.)

The paper's central result is a *crossover*: Idle-Waiting wins for request
periods below T_cross (499.06 ms with power-saving methods 1+2), On-Off
wins above it.  The repo's static strategies require picking one up front;
this module chooses **online**:

* :class:`AdaptiveStrategy` — the analytical controller.  Given a request
  period it applies the closed-form decision rule
  ``T_req ≤ T_cross → Idle-Waiting else On-Off`` and returns the winning
  static strategy's result *bit-identically* (it delegates to the same
  closed forms in :mod:`repro_torch.core.energy_model`).

* :class:`PolicyController` — the runtime controller.  It estimates the
  inter-arrival distribution online (EWMA mean + dispersion), and maps the
  estimate to an **idle timeout** the serving layer enforces after each
  request:

      - stable estimate below T_cross  → never release        (Idle-Waiting)
      - stable estimate above T_cross  → release immediately  (On-Off)
      - warmup / bursty (high CV) / inside the hysteresis band
                                       → release after the BREAK-EVEN
        timeout T*_be = (E_item^OnOff − E_item^IW)/P_idle — the ski-rental
        hybrid, ≤2× the clairvoyant optimum on *any* arrival process.

  The hysteresis band (±``hysteresis`` around T_cross) guards the regime
  switch so estimate noise near the crossover cannot flap policies.

Every quantity comes from :mod:`repro_torch.core.energy_model`'s closed forms, so
the controller is configuration-aware by construction: improving the
configuration phase (Experiment 1) moves T_cross, and the controller's
switching point moves with it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import energy_model as em
from repro_torch.core.phases import WorkloadItem
from repro_torch.core.strategies import (
    IdlePowerMethod,
    IdleWaitingStrategy,
    OnOffStrategy,
    Strategy,
)

def measured_workload_item(
    name: str,
    config_mw: float,
    config_s: float,
    infer_mw: float,
    infer_s: float,
    idle_mw: float,
) -> WorkloadItem:
    """Two-phase workload item from live phase measurements — the shape both
    the duty-cycle controller and the multi-tenant scheduler feed the
    policy controller."""
    from repro_torch.core.phases import CONFIGURATION, INFERENCE, Phase

    return WorkloadItem(
        name=name,
        phases=(
            Phase(CONFIGURATION, config_mw, config_s * 1000.0),
            Phase(INFERENCE, infer_mw, infer_s * 1000.0),
        ),
        idle_power_mw=idle_mw,
    )


def controller_timeout_s(
    controller: "PolicyController", item: WorkloadItem
) -> Optional[float]:
    """Install the (re)measured item and convert the controller's ms timeout
    to the serving layer's seconds convention (``None`` = never release)."""
    controller.set_item(item)
    t_ms = controller.idle_timeout_ms()
    if math.isnan(t_ms):
        # A NaN timeout would silently behave as never-release inside the
        # simulator (``min(gap, nan) == gap``); fail safe to release-now.
        return 0.0
    return None if math.isinf(t_ms) else t_ms / 1000.0


#: Coefficient-of-variation above which arrivals are treated as bursty and
#: the controller stays on the ski-rental hybrid.  Deterministic streams
#: have CV→0 and Poisson CV→1 — for BOTH, the mean-threshold rule picks the
#: better static strategy (per-gap idle energy is linear in the gap, so the
#: expected-cost comparison between the statics depends only on the mean).
#: Only genuinely bursty/bimodal traffic (MMPP CV ≫ 1) benefits from the
#: break-even hybrid, so the cut sits well above Poisson.
DEFAULT_CV_BURSTY = 1.5


def break_even_timeout_ms(
    item: WorkloadItem,
    idle_power_mw: float,
    powerup_overhead_mj: float = 0.0,
) -> float:
    """T*_be: idle long enough that idling has cost one reconfiguration.

    ``P_idle · T*_be = E_item^OnOff − E_item^IW``, i.e. the idle duration
    whose energy equals what a release would have saved.  Note
    ``T_cross = T*_be + T_latency^IW`` (energy_model.crossover_period_ms).
    """
    if idle_power_mw <= 0:
        return math.inf
    saved = em.onoff_item_energy_mj(item, powerup_overhead_mj) - em.idlewait_item_energy_mj(item)
    # When a release saves nothing (cheap-config items, over-subtracted
    # power-up calibration, or NaN energies) the correct limit is "release
    # immediately".  ``not (saved > 0)`` — rather than ``max(saved, 0.0)`` —
    # also catches NaN, which would otherwise flow through
    # ``controller_timeout_s`` into the simulator as a never-release timeout.
    if not saved > 0.0:
        return 0.0
    return saved * 1000.0 / idle_power_mw


@dataclasses.dataclass(frozen=True)
class AdaptiveStrategy(Strategy):
    """Analytical adaptive controller: picks the winning static strategy at
    each request period via the closed-form crossover.

    ``method`` selects the idle-power method of the Idle-Waiting arm;
    ``hysteresis`` widens the decision into a band (relative, e.g. 0.1 =
    ±10% of T_cross) inside which ``decide`` keeps ``previous`` — the
    runtime flap guard.  ``evaluate`` itself uses the pure threshold so its
    results are bit-identical to the winning static strategy.
    """

    method: IdlePowerMethod = IdlePowerMethod.BASELINE
    hysteresis: float = 0.1
    name: str = "adaptive"

    @property
    def onoff(self) -> OnOffStrategy:
        return OnOffStrategy(self.item, self.powerup_overhead_mj)

    @property
    def idlewait(self) -> IdleWaitingStrategy:
        return IdleWaitingStrategy(
            self.item, self.powerup_overhead_mj, method=self.method
        )

    def crossover_ms(self) -> float:
        return self.idlewait.crossover_vs_onoff_ms()

    def decide(self, request_period_ms: float, previous: Optional[str] = None) -> str:
        """'idle_waiting' | 'on_off'.  With ``previous`` given, the decision
        only changes once the period leaves the hysteresis band."""
        cross = self.crossover_ms()
        if previous in ("idle_waiting", "on_off") and self.hysteresis > 0:
            lo = cross * (1.0 - self.hysteresis)
            hi = cross * (1.0 + self.hysteresis)
            if lo <= request_period_ms <= hi:
                return previous
        return "idle_waiting" if request_period_ms <= cross else "on_off"

    def select(self, request_period_ms: float) -> Strategy:
        """The static strategy the controller converges to at this period."""
        if self.decide(request_period_ms) == "idle_waiting":
            return self.idlewait
        return self.onoff

    def evaluate(self, request_period_ms: float, e_budget_mj: float) -> em.StrategyResult:
        winner = self.select(request_period_ms)
        r = winner.evaluate(request_period_ms, e_budget_mj)
        return dataclasses.replace(r, strategy=f"adaptive→{r.strategy}")

    def min_request_period_ms(self) -> float:
        # the IW arm serves any period down to the execution latency
        return self.idlewait.min_request_period_ms()


class PolicyController:
    """Online policy: observed inter-arrival gaps → per-gap idle timeout.

    The serving layer (or the trace simulator) feeds observed gaps via
    :meth:`observe_gap` and, after each completed request, enforces
    :meth:`idle_timeout_ms`: stay resident that long, then release.
    ``math.inf`` = never release (Idle-Waiting); ``0`` = release immediately
    (On-Off); the break-even timeout = ski-rental hybrid.
    """

    def __init__(
        self,
        item: Optional[WorkloadItem] = None,
        method: IdlePowerMethod = IdlePowerMethod.BASELINE,
        powerup_overhead_mj: float = 0.0,
        ewma_alpha: float = 0.3,
        var_alpha: Optional[float] = None,
        hysteresis: float = 0.1,
        min_observations: int = 3,
        cv_bursty: float = DEFAULT_CV_BURSTY,
        idle_power_mw: Optional[float] = None,
    ):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.method = method
        self.powerup_overhead_mj = powerup_overhead_mj
        self.ewma_alpha = ewma_alpha
        # dispersion remembers much longer than the mean: a burst must not
        # wash out the memory of the quiet gaps that make the stream bursty,
        # and Poisson's noisy squared deviations (excess kurtosis 6) need a
        # long window to concentrate their CV near 1
        self.var_alpha = ewma_alpha / 16.0 if var_alpha is None else var_alpha
        self.hysteresis = hysteresis
        self.min_observations = min_observations
        self.cv_bursty = cv_bursty
        self._idle_power_override = idle_power_mw
        self._mean_ms: Optional[float] = None
        self._var_ms2: float = 0.0
        self.n_observed = 0
        self.regime_switches = 0
        self._regime: str = "hybrid"
        self._bursty = False
        self.item: Optional[WorkloadItem] = None
        if item is not None:
            self.set_item(item)

    # ---- configuration-aware inputs ---------------------------------------
    def set_item(self, item: WorkloadItem) -> None:
        """(Re)install the measured workload item.  Serving controllers call
        this as phase measurements improve; the thresholds follow."""
        self.item = item

    @property
    def idle_power_mw(self) -> float:
        if self._idle_power_override is not None:
            return self._idle_power_override
        assert self.item is not None, "no workload item installed"
        if self.method is IdlePowerMethod.BASELINE:
            return self.item.idle_power_mw
        from repro_torch.core.strategies import IDLE_POWER_MW

        return IDLE_POWER_MW[self.method]

    def crossover_ms(self) -> float:
        assert self.item is not None, "no workload item installed"
        return em.crossover_period_ms(
            self.item, self.idle_power_mw, self.powerup_overhead_mj
        )

    def break_even_ms(self) -> float:
        assert self.item is not None, "no workload item installed"
        return break_even_timeout_ms(
            self.item, self.idle_power_mw, self.powerup_overhead_mj
        )

    # ---- online estimation ------------------------------------------------
    def observe_gap(self, gap_ms: float) -> None:
        """Feed one observed inter-arrival gap (ms)."""
        if gap_ms < 0:
            raise ValueError(f"negative gap {gap_ms}")
        self.n_observed += 1
        if self._mean_ms is None:
            self._mean_ms = gap_ms
            self._var_ms2 = 0.0
            return
        a = self.ewma_alpha
        delta = gap_ms - self._mean_ms
        self._mean_ms += a * delta
        # EWMA of squared deviation around the (pre-update) mean, with its
        # own (slower) smoothing constant
        av = self.var_alpha
        self._var_ms2 = (1.0 - av) * self._var_ms2 + av * delta * delta

    @property
    def estimate_ms(self) -> Optional[float]:
        return self._mean_ms

    @property
    def cv(self) -> float:
        """Coefficient of variation of the inter-arrival estimate."""
        if not self._mean_ms:
            return 0.0
        return math.sqrt(max(self._var_ms2, 0.0)) / self._mean_ms

    # ---- decision ----------------------------------------------------------
    def regime(self) -> str:
        """'idle_waiting' | 'on_off' | 'hybrid' (warmup/bursty/band)."""
        if self.item is None or self.n_observed < self.min_observations:
            return self._set_regime("hybrid")
        # Schmitt trigger on burstiness: latch at cv_bursty, release only
        # at half of it, so mid-burst dips in the (noisy) CV estimate don't
        # flap the classification.
        if self._bursty:
            if self.cv < self.cv_bursty * 0.5:
                self._bursty = False
        elif self.cv > self.cv_bursty:
            self._bursty = True
        if self._bursty:
            return self._set_regime("hybrid")
        est, cross = self._mean_ms, self.crossover_ms()
        lo, hi = cross * (1.0 - self.hysteresis), cross * (1.0 + self.hysteresis)
        if self._regime in ("idle_waiting", "on_off") and lo <= est <= hi:
            return self._regime  # inside the guard band: hold
        return self._set_regime("idle_waiting" if est <= cross else "on_off")

    def _set_regime(self, regime: str) -> str:
        if regime != self._regime:
            self.regime_switches += 1
        self._regime = regime
        return regime

    def idle_timeout_ms(self) -> float:
        """How long to stay resident after a request before releasing."""
        if self.item is None:
            # nothing measured yet: stay resident (matches the serving
            # controller's pre-measurement behavior)
            return math.inf
        regime = self.regime()
        if regime == "idle_waiting":
            return math.inf
        if regime == "on_off":
            return 0.0
        return self.break_even_ms()

    def summary(self) -> dict:
        return {
            "regime": self._regime,
            "estimate_ms": self._mean_ms,
            "cv": self.cv,
            "crossover_ms": self.crossover_ms() if self.item is not None else None,
            "break_even_ms": self.break_even_ms() if self.item is not None else None,
            "observations": self.n_observed,
            "regime_switches": self.regime_switches,
        }


@dataclasses.dataclass(frozen=True)
class FixedTimeoutPolicy:
    """A constant idle-timeout policy with the simulate_trace interface —
    e.g. the ski-rental break-even arm (:func:`break_even_timeout_ms`) as a
    standalone policy, the scalar oracle for the fleet kernel's 'adaptive'
    devices."""

    timeout_ms: float
    idle_power_mw: float
    kind: str = "fixed_timeout"

    def __post_init__(self):
        if self.timeout_ms < 0:
            raise ValueError(f"timeout must be non-negative, got {self.timeout_ms}")

    def observe_gap(self, gap_ms: float) -> None:
        pass

    def idle_timeout_ms(self) -> float:
        return self.timeout_ms


@dataclasses.dataclass(frozen=True)
class StaticPolicy:
    """A fixed-timeout policy with the simulate_trace interface: 'on_off'
    releases immediately, 'idle_waiting' never releases."""

    kind: str
    item: WorkloadItem
    method: IdlePowerMethod = IdlePowerMethod.BASELINE
    powerup_overhead_mj: float = 0.0

    def __post_init__(self):
        if self.kind not in ("on_off", "idle_waiting"):
            raise ValueError(f"unknown static policy {self.kind!r}")

    @property
    def idle_power_mw(self) -> float:
        if self.method is IdlePowerMethod.BASELINE:
            return self.item.idle_power_mw
        from repro_torch.core.strategies import IDLE_POWER_MW

        return IDLE_POWER_MW[self.method]

    def observe_gap(self, gap_ms: float) -> None:
        pass

    def idle_timeout_ms(self) -> float:
        return 0.0 if self.kind == "on_off" else math.inf
