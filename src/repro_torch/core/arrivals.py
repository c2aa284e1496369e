"""Request-arrival processes for duty-cycle workloads (paper §7 future work);
the scalar half of ``repro.core.arrivals`` for the port.

The paper evaluates a *constant* request period; its stated future work is
irregular arrivals.  This module generates realistic request streams that
both the discrete-event simulator (:func:`repro_torch.core.simulator.simulate_trace`)
and the live serving layer (:mod:`repro_torch.serving.scheduler`) consume:

* :class:`DeterministicArrivals` — the paper's duty-cycle mode (period T);
* :class:`JitteredArrivals`      — the duty-cycle mode with relative Gaussian
  timing noise (jitter 0 is the deterministic mode exactly);
* :class:`PoissonArrivals`       — memoryless traffic at a mean period;
* :class:`MMPPArrivals`          — 2-state Markov-modulated Poisson process:
  bursts of fast requests separated by long quiet stretches (event-triggered
  sensors, diurnal tenants);
* :class:`DiurnalArrivals`       — MMPP with diurnal rate modulation: a
  sinusoidal day-cycle carrier rate, optionally interrupted by geometric
  bursts (regime-switching tenants);
* :class:`FlashCrowdArrivals`    — quiet Poisson baseline punctuated by
  fixed-length flash crowds (thundering herds);
* :class:`TraceArrivals`         — replay of a recorded trace (one
  inter-arrival gap in ms per line; ``#`` comments allowed).

All processes are seeded and deterministic: the same ``(process, n, seed)``
triple always yields the same stream, drawn from numpy's ``default_rng`` as
in the reference, so the two packages agree sample for sample.  Times are
milliseconds, matching :mod:`repro_torch.core.phases`; the first request
arrives at t = 0.

Fleet-scale vectorization (:mod:`repro_torch.fleet`):
:meth:`ArrivalProcess.sample_batch` draws **one independent stream per
device** as a padded float64 tensor — no Python loop over devices — and
:func:`bin_arrival_counts` histograms those streams onto the fleet
stepper's tick grid.  The reference's ``jax.random`` key becomes a
``torch.Generator``: the tensors land on its device.  Each sampler is a
draw stage (:meth:`ArrivalProcess._draws`, the random numbers) and a
transform stage (:meth:`ArrivalProcess._gaps_from_draws`, the process), so
the same draws can be fed to both packages.  The chained processes (MMPP,
diurnal, flash crowd) advance every device at once in a loop over the gap
index, where the reference runs a ``lax.scan``.
"""
from __future__ import annotations

import dataclasses
import io
import math
from typing import Union

import numpy as np
import torch

_F64 = torch.float64


def _uniform(g: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, dtype=_F64, device=g.device)


def _exponential(g: torch.Generator, shape) -> torch.Tensor:
    return torch.empty(shape, dtype=_F64, device=g.device).exponential_(generator=g)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float64 tensor on ``like``'s device: ``torch.where`` of two
    Python floats would give the default (float32) dtype."""
    return torch.full((), float(x), dtype=_F64, device=like.device)


def _require_positive_rate(name: str, value: float, what: str = "rate") -> None:
    """Reject non-finite (NaN/inf) and non-positive timing constants.

    A NaN mean period passes a naive ``<= 0`` test (every comparison with
    NaN is False) and then propagates silently into every gap; this helper
    turns that into an immediate, attributable ``ValueError``.
    """
    if not (math.isfinite(value) and value > 0):
        raise ValueError(
            f"{name}: {what} must be a finite, positive number of ms, got {value!r}"
        )


class ArrivalProcess:
    """Base interface: a generator of inter-arrival gaps (ms)."""

    name: str = "abstract"

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` inter-arrival gaps (ms), gap i separating request i from
        request i+1."""
        raise NotImplementedError

    def arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        """``n`` absolute arrival times (ms), the first at exactly 0.0."""
        if n <= 0:
            return np.zeros((0,), dtype=np.float64)
        gaps = np.asarray(self.inter_arrival_times(n - 1, seed), np.float64)
        return np.concatenate([[0.0], np.cumsum(gaps)])

    def mean_period_ms(self) -> float:
        """Expected inter-arrival gap (ms)."""
        raise NotImplementedError

    # ---- vectorized batch sampling (fleet substrate) ------------------------
    def _draws(self, generator: torch.Generator, n_devices: int, n_gaps: int) -> tuple:
        """The random numbers one batch consumes, drawn from ``generator``
        (the draw stage); subclasses override."""
        raise NotImplementedError(
            f"{type(self).__name__} has no vectorized batch sampler"
        )

    def _gaps_from_draws(self, *draws: torch.Tensor) -> torch.Tensor:
        """``(n_devices, n_gaps)`` float64 gaps from :meth:`_draws`' output
        (the transform stage), on the draws' device.  The draws have the
        reference's shapes, so ``jax.random``'s own output fed here gives
        the reference's gaps."""
        raise NotImplementedError(
            f"{type(self).__name__} has no vectorized batch sampler"
        )

    def _batch_gaps(self, generator: torch.Generator, n_devices: int, n_gaps: int) -> torch.Tensor:
        """``(n_devices, n_gaps)`` float64 inter-arrival gaps, one
        independent stream per row."""
        return self._gaps_from_draws(*self._draws(generator, n_devices, n_gaps))

    def sample_gaps(self, generator: torch.Generator, n_streams: int, n_gaps: int) -> torch.Tensor:
        """``(n_streams, n_gaps)`` float64 inter-arrival gaps (ms), one
        independent stream per row, on ``generator``'s device — the raw-gap
        companion of :meth:`sample_batch` (no horizon padding)."""
        if n_streams <= 0:
            raise ValueError(f"n_streams must be positive, got {n_streams}")
        if n_gaps < 0:
            raise ValueError(f"n_gaps must be non-negative, got {n_gaps}")
        return self._batch_gaps(generator, n_streams, n_gaps)

    def sample_batch(
        self,
        generator: torch.Generator,
        n_devices: int,
        horizon_ms: float,
        max_arrivals: int | None = None,
        include_origin: bool = True,
    ) -> torch.Tensor:
        """``(n_devices, M)`` float64 **arrival times** (ms), one stream per
        device, padded with ``+inf`` past the horizon, on ``generator``'s
        device.

        Each stream starts at exactly 0.0 (the scalar convention); pass
        ``include_origin=False`` to drop that deterministic first arrival
        (e.g. for thinned per-replica streams).  ``M`` is ``max_arrivals``
        or a mean-rate estimate with headroom; streams that would exceed
        ``M`` arrivals inside the horizon are truncated at ``M``.  The same
        generator state always yields the same batch on one device, and
        different rows are independent.  The times are a ``torch.cumsum``
        of the gaps: on the card it sums in another order than on the CPU,
        so a time can differ in its last bits between the two.
        """
        if n_devices <= 0:
            raise ValueError(f"n_devices must be positive, got {n_devices}")
        if not horizon_ms > 0:
            raise ValueError(f"horizon_ms must be positive, got {horizon_ms}")
        mean = self.mean_period_ms()
        if max_arrivals is None:
            # mean-rate estimate + 4·sqrt headroom for stochastic streams
            est = horizon_ms / mean
            max_arrivals = int(est + 4.0 * math.sqrt(est) + 8.0)
        if max_arrivals < 1:
            raise ValueError(f"max_arrivals must be ≥ 1, got {max_arrivals}")
        if include_origin:
            gaps = self._batch_gaps(generator, n_devices, max_arrivals - 1)
            times = torch.cat(
                [torch.zeros((n_devices, 1), dtype=_F64, device=gaps.device),
                 torch.cumsum(gaps, dim=1)],
                dim=1,
            )
        else:
            times = torch.cumsum(self._batch_gaps(generator, n_devices, max_arrivals), dim=1)
        # half-open horizon [0, horizon_ms): consistent with
        # bin_arrival_counts, which bins ticks [k·dt, (k+1)·dt)
        return torch.where(times < horizon_ms, times, torch.inf)


@dataclasses.dataclass(frozen=True)
class DeterministicArrivals(ArrivalProcess):
    """Constant request period — the paper's duty-cycle mode."""

    period_ms: float
    name: str = "deterministic"

    def __post_init__(self):
        _require_positive_rate("DeterministicArrivals", self.period_ms, "period")

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        return np.full((n,), self.period_ms, dtype=np.float64)

    def mean_period_ms(self) -> float:
        return self.period_ms

    def _draws(self, generator, n_devices, n_gaps):
        # no randomness: a carrier of the batch's shape and device
        return (torch.empty((n_devices, n_gaps), dtype=_F64, device=generator.device),)

    def _gaps_from_draws(self, shape_like):
        return torch.full_like(shape_like, self.period_ms)


@dataclasses.dataclass(frozen=True)
class JitteredArrivals(ArrivalProcess):
    """Periodic requests with relative Gaussian timing jitter.

    Gap ~ ``period_ms · max(1 + jitter · ε, 0)`` with ε standard normal —
    the duty-cycle mode as a real deployment sees it (sensor clock drift,
    network scheduling noise).  ``jitter=0`` reproduces
    :class:`DeterministicArrivals` *exactly* (every gap equals
    ``period_ms`` bit-for-bit).

    The clip at 0 keeps gaps physical; for ``jitter ≲ 0.3`` the clipping
    probability is < 0.05% and the mean-period bias is negligible.
    """

    period_ms: float
    jitter: float = 0.1
    name: str = "jittered"

    def __post_init__(self):
        _require_positive_rate("JitteredArrivals", self.period_ms, "period")
        if not (math.isfinite(self.jitter) and self.jitter >= 0):
            raise ValueError(
                f"jitter must be a finite, non-negative fraction, got {self.jitter!r}"
            )

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        eps = rng.standard_normal(n)
        return self.period_ms * np.maximum(1.0 + self.jitter * eps, 0.0)

    def mean_period_ms(self) -> float:
        return self.period_ms

    def _draws(self, generator, n_devices, n_gaps):
        return (torch.randn((n_devices, n_gaps), generator=generator, dtype=_F64,
                            device=generator.device),)

    def _gaps_from_draws(self, eps):
        return self.period_ms * torch.clamp_min(1.0 + self.jitter * eps, 0.0)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: exponential gaps with the given mean."""

    mean_ms: float
    name: str = "poisson"

    def __post_init__(self):
        _require_positive_rate("PoissonArrivals", self.mean_ms, "mean period")

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.exponential(self.mean_ms, n)

    def mean_period_ms(self) -> float:
        return self.mean_ms

    def _draws(self, generator, n_devices, n_gaps):
        return (_exponential(generator, (n_devices, n_gaps)),)

    def _gaps_from_draws(self, u_exp):
        return u_exp * self.mean_ms


@dataclasses.dataclass(frozen=True)
class MMPPArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process (bursty traffic).

    State B (burst): exponential gaps with mean ``burst_ms``;
    state Q (quiet): exponential gaps with mean ``quiet_ms``.
    After each arrival the state flips with probability ``1/mean_burst_len``
    (from B) or ``1/mean_quiet_len`` (from Q) — dwell lengths are geometric,
    so bursts average ``mean_burst_len`` requests.
    """

    burst_ms: float
    quiet_ms: float
    mean_burst_len: float = 8.0
    mean_quiet_len: float = 1.0
    name: str = "mmpp"

    def __post_init__(self):
        _require_positive_rate("MMPPArrivals", self.burst_ms, "burst mean period")
        _require_positive_rate("MMPPArrivals", self.quiet_ms, "quiet mean period")
        # NaN dwell lengths pass a plain `< 1` test and turn the flip
        # probabilities into NaN — reject them alongside zero-length bursts.
        for name, dwell in (("mean_burst_len", self.mean_burst_len),
                            ("mean_quiet_len", self.mean_quiet_len)):
            if not (math.isfinite(dwell) and dwell >= 1):
                raise ValueError(
                    f"MMPPArrivals: {name} must be a finite dwell of ≥ 1 "
                    f"arrival (zero-length bursts are degenerate), got {dwell!r}"
                )

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        gaps = np.empty((n,), dtype=np.float64)
        in_burst = True
        for i in range(n):
            mean = self.burst_ms if in_burst else self.quiet_ms
            gaps[i] = rng.exponential(mean)
            p_flip = 1.0 / (self.mean_burst_len if in_burst else self.mean_quiet_len)
            if rng.random() < p_flip:
                in_burst = not in_burst
        return gaps

    def mean_period_ms(self) -> float:
        # stationary fraction of arrivals in each state ∝ mean dwell length
        b, q = self.mean_burst_len, self.mean_quiet_len
        return (b * self.burst_ms + q * self.quiet_ms) / (b + q)

    def _draws(self, generator, n_devices, n_gaps):
        return (_exponential(generator, (n_gaps, n_devices)),
                _uniform(generator, (n_gaps, n_devices)))

    def _gaps_from_draws(self, u_exp, u_flip):
        # Same 2-state chain as the scalar generator: the per-arrival state
        # flips run in a loop over the gap index with every device advanced
        # at once (the chain is sequential in i, never in d).
        burst, quiet = _const(self.burst_ms, u_exp), _const(self.quiet_ms, u_exp)
        p_b, p_q = _const(1.0 / self.mean_burst_len, u_exp), _const(1.0 / self.mean_quiet_len, u_exp)
        in_burst = torch.ones(u_exp.shape[1], dtype=torch.bool, device=u_exp.device)
        gaps = torch.empty_like(u_exp)
        for i in range(u_exp.shape[0]):
            gaps[i] = u_exp[i] * torch.where(in_burst, burst, quiet)
            in_burst = in_burst ^ (u_flip[i] < torch.where(in_burst, p_b, p_q))
        return gaps.T


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """MMPP with diurnal rate modulation (regime-switching tenant traffic).

    The quiet state is a Poisson stream whose rate follows a day cycle:
    ``λ(t) = (1 + amplitude · sin(2π·(t/day_ms + phase_frac))) / mean_ms``,
    sampled per-gap with the rate frozen at the arrival time (exact in the
    ``day_ms ≫ gap`` regime this models).  When ``burst_ms`` is set, a
    2-state chain identical to :class:`MMPPArrivals` is layered on top:
    bursts of fast requests (mean gap ``burst_ms``, geometric dwell
    ``mean_burst_len``) interrupt the diurnal carrier.  ``amplitude=0`` with
    no burst state is *exactly* :class:`PoissonArrivals`.
    """

    mean_ms: float
    day_ms: float
    amplitude: float = 0.5
    phase_frac: float = 0.0
    burst_ms: float | None = None
    mean_burst_len: float = 8.0
    mean_quiet_len: float = 8.0
    name: str = "diurnal"

    def __post_init__(self):
        _require_positive_rate("DiurnalArrivals", self.mean_ms, "mean period")
        _require_positive_rate("DiurnalArrivals", self.day_ms, "day length")
        # amplitude ≥ 1 makes the instantaneous rate non-positive at the
        # trough (gap mean → ∞ or negative); NaN fails both comparisons.
        if not (0.0 <= self.amplitude < 1.0):
            raise ValueError(
                f"DiurnalArrivals: amplitude must be in [0, 1), got {self.amplitude!r}"
            )
        if not (math.isfinite(self.phase_frac)):
            raise ValueError(
                f"DiurnalArrivals: phase_frac must be finite, got {self.phase_frac!r}"
            )
        if self.burst_ms is not None:
            _require_positive_rate("DiurnalArrivals", self.burst_ms, "burst mean period")
            for nm, dwell in (("mean_burst_len", self.mean_burst_len),
                              ("mean_quiet_len", self.mean_quiet_len)):
                if not (math.isfinite(dwell) and dwell >= 1):
                    raise ValueError(
                        f"DiurnalArrivals: {nm} must be a finite dwell of ≥ 1 "
                        f"arrival, got {dwell!r}"
                    )

    def _quiet_mean(self, t_ms: float) -> float:
        phase = 2.0 * math.pi * (t_ms / self.day_ms + self.phase_frac)
        return self.mean_ms / (1.0 + self.amplitude * math.sin(phase))

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        gaps = np.empty((n,), dtype=np.float64)
        t = 0.0
        in_burst = False
        has_bursts = self.burst_ms is not None
        for i in range(n):
            mean = self.burst_ms if in_burst else self._quiet_mean(t)
            gaps[i] = rng.exponential(mean)
            t += gaps[i]
            if has_bursts:
                p_flip = 1.0 / (
                    self.mean_burst_len if in_burst else self.mean_quiet_len
                )
                if rng.random() < p_flip:
                    in_burst = not in_burst
        return gaps

    def mean_period_ms(self) -> float:
        # The modulation integrates to zero over a day, so arrivals/day is
        # day_ms/mean_ms and the long-run mean gap of the carrier is mean_ms;
        # with bursts, weight states by dwell length as in MMPPArrivals.
        if self.burst_ms is None:
            return self.mean_ms
        b, q = self.mean_burst_len, self.mean_quiet_len
        return (b * self.burst_ms + q * self.mean_ms) / (b + q)

    def _draws(self, generator, n_devices, n_gaps):
        return (_exponential(generator, (n_gaps, n_devices)),
                _uniform(generator, (n_gaps, n_devices)))

    def _gaps_from_draws(self, u_exp, u_flip):
        # One loop over the gap index, carrying (cumulative time, burst
        # state) per device — the diurnal phase is a function of the carried
        # clock, so rows advance through their own day cycles independently.
        # sin (and the reference's compiled scan, which may multiply by
        # 1/day_ms) leave the gaps equal to the reference's within 1e-12
        # relative, not bit for bit.
        has_bursts = self.burst_ms is not None
        burst = _const(self.burst_ms if has_bursts else self.mean_ms, u_exp)
        p_b = _const(1.0 / self.mean_burst_len if has_bursts else 0.0, u_exp)
        p_q = _const(1.0 / self.mean_quiet_len if has_bursts else 0.0, u_exp)
        mean, day = _const(self.mean_ms, u_exp), _const(self.day_ms, u_exp)
        two_pi = 2.0 * math.pi
        n_devices = u_exp.shape[1]
        t = torch.zeros(n_devices, dtype=_F64, device=u_exp.device)
        in_burst = torch.zeros(n_devices, dtype=torch.bool, device=u_exp.device)
        gaps = torch.empty_like(u_exp)
        for i in range(u_exp.shape[0]):
            phase = two_pi * (torch.div(t, day) + self.phase_frac)
            quiet_mean = torch.div(mean, 1.0 + self.amplitude * torch.sin(phase))
            gaps[i] = u_exp[i] * torch.where(in_burst, burst, quiet_mean)
            t = t + gaps[i]
            in_burst = in_burst ^ (u_flip[i] < torch.where(in_burst, p_b, p_q))
        return gaps.T


@dataclasses.dataclass(frozen=True)
class FlashCrowdArrivals(ArrivalProcess):
    """Quiet Poisson baseline punctuated by fixed-length flash crowds.

    Quiet-state gaps are exponential with mean ``quiet_ms``; after each
    quiet arrival a flash starts with probability ``1/flash_every``, during
    which exactly ``flash_len`` gaps are exponential with mean
    ``flash_gap_ms`` before the stream drops back to quiet.  Unlike
    :class:`MMPPArrivals` (geometric dwells), the flash length is
    *deterministic* — the thundering-herd / cache-stampede shape.
    """

    quiet_ms: float
    flash_gap_ms: float
    flash_len: int = 32
    flash_every: float = 4.0
    name: str = "flash_crowd"

    def __post_init__(self):
        _require_positive_rate("FlashCrowdArrivals", self.quiet_ms, "quiet mean period")
        _require_positive_rate("FlashCrowdArrivals", self.flash_gap_ms, "flash mean gap")
        if not (isinstance(self.flash_len, int) and self.flash_len >= 1):
            raise ValueError(
                f"FlashCrowdArrivals: flash_len must be an int ≥ 1, got {self.flash_len!r}"
            )
        if not (math.isfinite(self.flash_every) and self.flash_every >= 1):
            raise ValueError(
                f"FlashCrowdArrivals: flash_every must be a finite number ≥ 1 "
                f"of quiet arrivals per flash trigger, got {self.flash_every!r}"
            )

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        gaps = np.empty((n,), dtype=np.float64)
        remaining = 0
        p_trigger = 1.0 / self.flash_every
        for i in range(n):
            if remaining > 0:
                gaps[i] = rng.exponential(self.flash_gap_ms)
                remaining -= 1
            else:
                gaps[i] = rng.exponential(self.quiet_ms)
                if rng.random() < p_trigger:
                    remaining = self.flash_len
        return gaps

    def mean_period_ms(self) -> float:
        # Per cycle: geometric(1/flash_every) quiet gaps (mean flash_every)
        # followed by exactly flash_len flash gaps — exact stationary mean.
        return (
            self.flash_every * self.quiet_ms + self.flash_len * self.flash_gap_ms
        ) / (self.flash_every + self.flash_len)

    def _draws(self, generator, n_devices, n_gaps):
        return (_exponential(generator, (n_gaps, n_devices)),
                _uniform(generator, (n_gaps, n_devices)))

    def _gaps_from_draws(self, u_exp, u_trig):
        # a loop over the gap index carrying the per-device countdown of
        # remaining flash arrivals (0 = quiet state)
        flash, quiet = _const(self.flash_gap_ms, u_exp), _const(self.quiet_ms, u_exp)
        p_trigger = _const(1.0 / self.flash_every, u_exp)
        remaining = torch.zeros(u_exp.shape[1], dtype=torch.int32, device=u_exp.device)
        flash_len = torch.full_like(remaining, self.flash_len)
        gaps = torch.empty_like(u_exp)
        for i in range(u_exp.shape[0]):
            in_flash = remaining > 0
            gaps[i] = u_exp[i] * torch.where(in_flash, flash, quiet)
            triggered = ~in_flash & (u_trig[i] < p_trigger)
            remaining = torch.where(
                in_flash, remaining - 1, torch.where(triggered, flash_len, 0)
            )
        return gaps.T


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay of a recorded gap trace; cycles if more gaps are requested
    than recorded."""

    gaps_ms: tuple
    name: str = "trace"

    def __post_init__(self):
        if not self.gaps_ms:
            raise ValueError("trace must contain at least one gap")
        for i, g in enumerate(self.gaps_ms):
            # `g < 0` alone lets NaN through (NaN compares False), and a NaN
            # gap then corrupts every cumulative arrival time downstream
            if not (math.isfinite(g) and g >= 0):
                raise ValueError(
                    f"trace gap [{i}] = {g!r}: gaps must be finite and non-negative"
                )
        if not any(g > 0 for g in self.gaps_ms):
            raise ValueError(
                "trace gaps are all zero (zero-length bursts only): the mean "
                "request period would be 0 ms, an infinite arrival rate"
            )

    def inter_arrival_times(self, n: int, seed: int = 0) -> np.ndarray:
        reps = math.ceil(n / len(self.gaps_ms)) if n else 0
        return np.asarray((self.gaps_ms * reps)[:n], np.float64)

    def mean_period_ms(self) -> float:
        return float(np.mean(self.gaps_ms))

    # ---- trace files: one inter-arrival gap (ms) per line -------------------
    @staticmethod
    def from_file(fp: Union[str, io.IOBase]) -> "TraceArrivals":
        if isinstance(fp, str):
            with open(fp) as f:
                return TraceArrivals.from_file(f)
        gaps = []
        for lineno, line in enumerate(fp, start=1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            try:
                gaps.append(float(line))
            except ValueError:
                name = getattr(fp, "name", "<trace>")
                raise ValueError(
                    f"{name}:{lineno}: expected an inter-arrival gap in ms, "
                    f"got {line!r}"
                ) from None
        return TraceArrivals(tuple(gaps))

    def to_file(self, fp: Union[str, io.IOBase]) -> None:
        if isinstance(fp, str):
            with open(fp, "w") as f:
                self.to_file(f)
            return
        fp.write("# inter-arrival gaps in ms, one per line\n")
        for g in self.gaps_ms:
            fp.write(f"{g!r}\n")

    @staticmethod
    def record(process: ArrivalProcess, n: int, seed: int = 0) -> "TraceArrivals":
        """Snapshot another process into a replayable trace."""
        return TraceArrivals(tuple(process.inter_arrival_times(n, seed).tolist()))


def bin_arrival_counts(times_ms, horizon_ms: float, dt_ms: float) -> torch.Tensor:
    """Histogram per-device arrival times onto a tick grid.

    ``times_ms`` is ``(n_devices, M)`` (array or tensor; ``+inf`` padding
    and times outside ``[0, n_steps·dt_ms)`` are ignored).  Returns
    ``(n_steps, n_devices)`` int32 counts with
    ``n_steps = ceil(horizon_ms / dt_ms)``, tick k holding the arrivals in
    ``[k·dt_ms, (k+1)·dt_ms)``, on the device of ``times_ms``.
    """
    if not dt_ms > 0:
        raise ValueError(f"dt_ms must be positive, got {dt_ms}")
    if not horizon_ms > 0:
        raise ValueError(f"horizon_ms must be positive, got {horizon_ms}")
    n_steps = int(math.ceil(horizon_ms / dt_ms))
    t = torch.as_tensor(times_ms, dtype=torch.float64)
    if t.ndim != 2:
        raise ValueError(f"times_ms must be (n_devices, M), got shape {tuple(t.shape)}")
    n_devices = t.shape[0]
    valid = torch.isfinite(t) & (t >= 0) & (t < n_steps * dt_ms)
    # invalid times add 0 at tick 0: no cast of inf or of a huge time to int
    step = torch.floor(torch.where(valid, t, 0.0) / dt_ms).long().clamp_(0, n_steps - 1)
    cell = step * n_devices + torch.arange(n_devices, device=t.device)[:, None]
    counts = torch.zeros(n_steps * n_devices, dtype=torch.int32, device=t.device)
    counts.scatter_add_(0, cell.reshape(-1), valid.reshape(-1).to(torch.int32))
    return counts.view(n_steps, n_devices)


def make_process(kind: str, **kwargs) -> ArrivalProcess:
    """Factory for YAML/CLI-driven experiments."""
    kinds = {
        "deterministic": DeterministicArrivals,
        "jittered": JitteredArrivals,
        "poisson": PoissonArrivals,
        "mmpp": MMPPArrivals,
        "bursty": MMPPArrivals,
        "diurnal": DiurnalArrivals,
        "flash_crowd": FlashCrowdArrivals,
        "trace": TraceArrivals,
    }
    if kind not in kinds:
        raise ValueError(f"unknown arrival process {kind!r}; choose from {sorted(kinds)}")
    return kinds[kind](**kwargs)
