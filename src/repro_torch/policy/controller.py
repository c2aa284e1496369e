"""Serving-side wrapper: the trained policy as a drop-in PolicyController
(port of ``repro.policy.controller``; host Python, no tensors).

:class:`LearnedTimeoutPolicy` speaks the exact duck-typed protocol of
:class:`repro_torch.core.adaptive.PolicyController` (``set_item`` /
``observe_gap`` / ``idle_timeout_ms`` / ``idle_power_mw`` / ``summary`` /
``regime``), so it slots unchanged into every consumer of that protocol:
:func:`repro_torch.core.adaptive.controller_timeout_s`,
:func:`repro_torch.core.simulator.simulate_trace`,
:class:`repro_torch.core.duty_cycle.DutyCycleController` (``policy=``), and
:class:`repro_torch.serving.multi_tenant.Tenant` (``controller=``).

**The stationarity guard** is the contract that makes the learned policy
safe to deploy: the paper's crossover rule is *provably optimal* for
stationary arrivals, so the network is only allowed to drive when the
observed stream is measurably non-stationary.  The guard keeps
prior-seeded cumulative (Welford) mean/dispersion statistics; while the
cumulative CV stays below ``cv_stationary`` (Schmitt-latched, like the
analytical controller's burstiness trigger) the wrapper emits the
*closed-form* decision — timeout ``inf`` below the crossover, ``0`` above,
with the same ±hysteresis hold — reproducing
:meth:`repro_torch.core.adaptive.AdaptiveStrategy.decide` bit-for-bit.  Only
when the CV latch trips (bursty / regime-switching traffic, where the
closed form is no longer optimal) does the MLP timeout take over.  The
hot path is pure numpy — no tensor dispatch per request.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import DEFAULT_CV_BURSTY, break_even_timeout_ms
from repro_torch.core.phases import WorkloadItem
from repro_torch.core.strategies import IDLE_POWER_MW, IdlePowerMethod
from repro_torch.policy import features as F
from repro_torch.policy import net as N
from repro_torch.policy.train import TrainedPolicy


class LearnedTimeoutPolicy:
    """Online learned timeout provider with an analytical stationarity guard.

    Parameters mirror :class:`~repro_torch.core.adaptive.PolicyController` where
    they overlap; the extras:

    ``prior_period_ms``
        Optional nominal request period.  Seeds the guard statistics with
        ``prior_weight`` pseudo-observations, so a tenant whose declared
        period is trusted gets the closed-form decision from the very first
        request (the stationary-limit benchmark setting).
    ``guard``
        Set ``False`` to let the network drive unconditionally (training
        diagnostics only — deployments keep the guard on).
    ``snap_lo`` / ``snap_hi``
        Network timeouts at/below ``snap_lo·T*_be`` collapse to 0 (On-Off),
        at/above ``snap_hi·T*_be`` to ``inf`` (Idle-Waiting): outside that
        range the distinction is unobservable on real gaps, and snapping
        makes the learned limits *exactly* the static strategies.
    """

    kind = "learned"

    def __init__(
        self,
        trained: TrainedPolicy,
        item: Optional[WorkloadItem] = None,
        method: Optional[IdlePowerMethod] = None,
        powerup_overhead_mj: Optional[float] = None,
        idle_power_mw: Optional[float] = None,
        prior_period_ms: Optional[float] = None,
        prior_weight: float = 8.0,
        guard: bool = True,
        cv_stationary: float = DEFAULT_CV_BURSTY,
        hysteresis: float = 0.1,
        guard_min_obs: int = 8,
        snap_lo: float = 1.0 / 64.0,
        snap_hi: float = 64.0,
    ):
        self.trained = trained
        self._np_params = [
            {"w": layer["w"], "b": layer["b"]} for layer in trained.params
        ]
        meta = trained.meta or {}
        if method is None:
            method = IdlePowerMethod[meta.get("method", "BASELINE")]
        self.method = method
        self.powerup_overhead_mj = (
            float(meta.get("powerup_overhead_mj", 0.0))
            if powerup_overhead_mj is None
            else powerup_overhead_mj
        )
        self._idle_power_override = idle_power_mw
        self.guard = guard
        self.cv_stationary = cv_stationary
        self.hysteresis = hysteresis
        self.guard_min_obs = guard_min_obs
        self.snap_lo = snap_lo
        self.snap_hi = snap_hi

        # online feature state (the network's inputs)
        self._fs = F.init_state()
        self.n_observed = 0
        # guard statistics: prior-seeded cumulative Welford mean/M2
        self._g_n = 0.0
        self._g_mean = 0.0
        self._g_m2 = 0.0
        if prior_period_ms is not None:
            if not (math.isfinite(prior_period_ms) and prior_period_ms > 0):
                raise ValueError(
                    f"prior_period_ms must be finite and positive, got {prior_period_ms!r}"
                )
            self._g_n = float(prior_weight)
            self._g_mean = float(prior_period_ms)
        self._bursty = False
        self._regime = "learned"
        self.regime_switches = 0

        self.item: Optional[WorkloadItem] = None
        if item is not None:
            self.set_item(item)

    # ---- configuration-aware inputs (PolicyController protocol) ------------
    def set_item(self, item: WorkloadItem) -> None:
        self.item = item

    @property
    def idle_power_mw(self) -> float:
        if self._idle_power_override is not None:
            return self._idle_power_override
        assert self.item is not None, "no workload item installed"
        if self.method is IdlePowerMethod.BASELINE:
            return self.item.idle_power_mw
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

    # ---- online estimation --------------------------------------------------
    def observe_gap(self, gap_ms: float) -> None:
        """Feed one observed inter-arrival gap (ms)."""
        if gap_ms < 0:
            raise ValueError(f"negative gap {gap_ms}")
        self.n_observed += 1
        self._fs = F.update_state_py(self._fs, gap_ms, self._t_be_feature())
        # guard statistics: cumulative Welford update (prior counts as
        # pseudo-observations, so a deterministic stream at the prior period
        # leaves the mean bit-identical to the period forever)
        self._g_n += 1.0
        delta = gap_ms - self._g_mean
        self._g_mean += delta / self._g_n
        self._g_m2 += delta * (gap_ms - self._g_mean)

    @property
    def estimate_ms(self) -> Optional[float]:
        return self._g_mean if self._g_n > 0 else None

    @property
    def cv(self) -> float:
        """Cumulative coefficient of variation of the observed gaps."""
        if self._g_n <= 0 or self._g_mean <= 0:
            return 0.0
        return math.sqrt(max(self._g_m2, 0.0) / self._g_n) / self._g_mean

    def _t_be_feature(self) -> float:
        """T*_be used for feature normalisation: the installed item's if
        available and sane, else the training item's."""
        if self.item is not None:
            t = self.break_even_ms()
            if math.isfinite(t) and t > 0:
                return t
        return self.trained.t_be_ms

    # ---- decision -----------------------------------------------------------
    def regime(self) -> str:
        """'idle_waiting' | 'on_off' (guard engaged) | 'learned' (MLP)."""
        if self.item is None:
            return self._set_regime("learned")
        if not self.guard:
            return self._set_regime("learned")
        # Schmitt trigger on the cumulative CV, same shape as the
        # analytical controller's burstiness latch
        if self._bursty:
            if self.cv < self.cv_stationary * 0.5:
                self._bursty = False
        elif self.cv > self.cv_stationary:
            self._bursty = True
        if self._bursty or self._g_n < self.guard_min_obs:
            return self._set_regime("learned")
        est, cross = self._g_mean, self.crossover_ms()
        lo, hi = cross * (1.0 - self.hysteresis), cross * (1.0 + self.hysteresis)
        if self._regime in ("idle_waiting", "on_off") and lo <= est <= hi:
            return self._regime  # inside the guard band: hold
        return self._set_regime("idle_waiting" if est <= cross else "on_off")

    def _set_regime(self, regime: str) -> str:
        if regime != self._regime:
            self.regime_switches += 1
        self._regime = regime
        return regime

    def network_timeout_ms(self) -> float:
        """The raw (snapped) MLP timeout, regardless of the guard."""
        t_be = self._t_be_feature()
        feats = F.feature_vector_py(self._fs, t_be)
        tau = N.timeout_ms_np(self._np_params, feats, t_be)
        if tau >= self.snap_hi * t_be:
            return math.inf
        if tau <= self.snap_lo * t_be:
            return 0.0
        return tau

    def idle_timeout_ms(self) -> float:
        """How long to stay resident after a request before releasing."""
        if self.item is None:
            # nothing measured yet: stay resident (PolicyController's
            # pre-measurement behavior)
            return math.inf
        t_be = self.break_even_ms()
        if not (math.isfinite(t_be) and t_be > 0):
            # degenerate physics: releasing saves nothing (t_be == 0 →
            # release now) or costs nothing to hold (inf → never release)
            return 0.0 if t_be == 0.0 else math.inf
        regime = self.regime()
        if regime == "idle_waiting":
            return math.inf
        if regime == "on_off":
            return 0.0
        return self.network_timeout_ms()

    def summary(self) -> dict:
        return {
            "regime": self._regime,
            "estimate_ms": self.estimate_ms,
            "cv": self.cv,
            "crossover_ms": self.crossover_ms() if self.item is not None else None,
            "break_even_ms": self.break_even_ms() if self.item is not None else None,
            "observations": self.n_observed,
            "regime_switches": self.regime_switches,
            "guard_engaged": self._regime in ("idle_waiting", "on_off"),
        }
