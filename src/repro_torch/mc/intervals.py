"""Confidence intervals for ensemble estimates: normal, bootstrap, Welford
(port of ``repro.mc.intervals``; numpy, so every function gives the
reference's result bit for bit).

Three interval constructions, chosen by what is available and what is being
claimed:

* :func:`normal_interval` — CLT band for the *mean* of S i.i.d. replication
  aggregates: ``mean ± z · s/√S``.  Cheap, exact in the large-S limit,
  assumes finite variance (every metric here has it).
* :func:`bootstrap_interval` — percentile bootstrap of the mean (or any
  statistic): no normality assumption, captures skew at moderate S.  Agrees
  with the normal band to a few percent for the well-behaved metrics in
  this repo — the mc CLI reports both and their disagreement.
* :func:`welford_interval` — the normal band read directly off streaming
  :class:`~repro_torch.mc.ensemble.Welford` moments, for per-device arrays whose
  S samples were never materialized.

:func:`percentile_interval` is the fourth, different, object: an empirical
*distribution band* (e.g. "95% of seeds see a crossover in [a, b]"), which
does **not** shrink with S — don't confuse it with a CI of the mean.

Degenerate ensembles are first-class: a zero-variance sample (the
deterministic limit) yields ``lo == mean == hi``, which is how
``BENCH_mc.json`` reproduces 499.06 ms and 12.39× *exactly* at zero jitter.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Callable, Optional

import numpy as np

from repro_torch.mc.ensemble import Welford

__all__ = [
    "ConfidenceInterval",
    "z_value",
    "normal_interval",
    "bootstrap_interval",
    "percentile_interval",
    "welford_interval",
    "ci_dict",
]


def z_value(confidence: float) -> float:
    """Two-sided standard-normal quantile: z such that P(|Z| ≤ z) = confidence.

    >>> round(z_value(0.95), 3)
    1.96
    """
    if not (0.0 < confidence < 1.0):
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    return NormalDist().inv_cdf(0.5 + confidence / 2.0)


@dataclasses.dataclass(frozen=True)
class ConfidenceInterval:
    """One interval estimate: point value, band, and how it was built."""

    mean: float
    lo: float
    hi: float
    std: float                 # sample std of the replications (ddof=1)
    sem: float                 # standard error of the mean
    n: int                     # replications the band is built from
    confidence: float
    method: str                # "normal" | "bootstrap" | "percentile" | "welford" | "delta"

    @property
    def half_width(self) -> float:
        return (self.hi - self.lo) / 2.0

    def covers(self, x: float) -> bool:
        return self.lo <= x <= self.hi

    def separated_from(self, other: "ConfidenceInterval") -> bool:
        """True when the two bands do not overlap (strictly disjoint).

        The non-overlap criterion the policy benchmark uses to declare a
        win: conservative relative to a two-sample test at the same
        confidence, so a ``True`` here is the stronger statement.

        >>> a = normal_interval([1.0, 1.1, 0.9, 1.0])
        >>> b = normal_interval([2.0, 2.1, 1.9, 2.0])
        >>> a.separated_from(b), a.separated_from(a)
        (True, False)
        """
        return self.hi < other.lo or other.hi < self.lo

    def to_dict(self) -> dict:
        return {
            "mean": self.mean,
            "lo": self.lo,
            "hi": self.hi,
            "half_width": self.half_width,
            "std": self.std,
            "sem": self.sem,
            "n": self.n,
            "confidence": self.confidence,
            "method": self.method,
        }


def _clean(samples) -> np.ndarray:
    s = np.asarray(samples, dtype=np.float64).ravel()
    if s.size == 0:
        raise ValueError("interval needs at least one sample")
    if not np.all(np.isfinite(s)):
        bad = int(np.sum(~np.isfinite(s)))
        raise ValueError(
            f"{bad}/{s.size} samples are non-finite; filter degenerate "
            "replications (e.g. seeds that served nothing) before building an interval"
        )
    return s


def normal_interval(samples, confidence: float = 0.95) -> ConfidenceInterval:
    """CLT interval for the mean of i.i.d. replication aggregates.

    >>> ci = normal_interval([1.0, 1.0, 1.0, 1.0])
    >>> (ci.lo, ci.mean, ci.hi)      # zero variance → degenerate band
    (1.0, 1.0, 1.0)
    """
    s = _clean(samples)
    z = z_value(confidence)
    mean = float(s.mean())
    std = float(s.std(ddof=1)) if s.size > 1 else 0.0
    sem = std / math.sqrt(s.size)
    return ConfidenceInterval(
        mean=mean, lo=mean - z * sem, hi=mean + z * sem,
        std=std, sem=sem, n=int(s.size), confidence=confidence, method="normal",
    )


def bootstrap_interval(
    samples,
    confidence: float = 0.95,
    n_boot: int = 2000,
    seed: int = 0,
    stat: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> ConfidenceInterval:
    """Percentile bootstrap of ``stat`` (default: the mean).

    Resampling is fully vectorized — an ``(n_boot, S)`` index draw per
    block, blocks bounded so memory stays ≲ 80 MB however large S grows.
    ``stat`` must reduce axis -1 (e.g. ``lambda x: np.percentile(x, 99,
    axis=-1)``).
    """
    s = _clean(samples)
    if n_boot < 1:
        raise ValueError(f"n_boot must be ≥ 1, got {n_boot}")
    reduce = stat if stat is not None else (lambda x: x.mean(axis=-1))
    rng = np.random.default_rng(seed)
    block = max(1, min(n_boot, 10_000_000 // s.size))
    stats = []
    drawn = 0
    while drawn < n_boot:
        b = min(block, n_boot - drawn)
        idx = rng.integers(0, s.size, size=(b, s.size))
        stats.append(np.asarray(reduce(s[idx]), dtype=np.float64))
        drawn += b
    stats = np.concatenate(stats)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(stats, [alpha, 1.0 - alpha])
    point = float(reduce(s[None, :])[0])
    return ConfidenceInterval(
        mean=point, lo=float(lo), hi=float(hi),
        std=float(s.std(ddof=1)) if s.size > 1 else 0.0,
        sem=float(stats.std(ddof=1)) if stats.size > 1 else 0.0,
        n=int(s.size), confidence=confidence, method="bootstrap",
    )


def percentile_interval(samples, confidence: float = 0.95) -> ConfidenceInterval:
    """Empirical distribution band: the central ``confidence`` mass of the
    replication distribution itself.  Width does NOT shrink with S."""
    s = _clean(samples)
    alpha = (1.0 - confidence) / 2.0
    lo, hi = np.quantile(s, [alpha, 1.0 - alpha])
    std = float(s.std(ddof=1)) if s.size > 1 else 0.0
    return ConfidenceInterval(
        mean=float(s.mean()), lo=float(lo), hi=float(hi),
        std=std, sem=std / math.sqrt(s.size),
        n=int(s.size), confidence=confidence, method="percentile",
    )


def ci_dict(samples, confidence: float = 0.95) -> dict:
    """Launcher-facing normal band: JSON-friendly and degeneracy-tolerant.

    Non-finite replications (e.g. energy-per-request of a seed that served
    nothing) are dropped; if *every* replication is degenerate the band is
    null rather than an exception — a CLI must still emit its artifact.

    >>> ci_dict([float("nan")])
    {'mean': None, 'lo': None, 'hi': None, 'std': None, 'n': 0}
    """
    s = np.asarray(samples, dtype=np.float64).ravel()
    s = s[np.isfinite(s)]
    if s.size == 0:
        return {"mean": None, "lo": None, "hi": None, "std": None, "n": 0}
    ci = normal_interval(s, confidence)
    return {"mean": ci.mean, "lo": ci.lo, "hi": ci.hi, "std": ci.std, "n": ci.n}


def welford_interval(moments: Welford, confidence: float = 0.95) -> dict:
    """Per-element normal CI arrays from streaming moments.

    Returns ``{"mean", "lo", "hi", "std", "sem", "n", "confidence"}`` with
    array values shaped like the accumulated statistic — the constant-memory
    companion of :func:`normal_interval` for per-device bands.
    """
    if moments.count < 1:
        raise ValueError("Welford has seen no replications")
    z = z_value(confidence)
    mean = np.asarray(moments.mean, dtype=np.float64)
    sem = np.asarray(moments.sem, dtype=np.float64)
    return {
        "mean": mean,
        "lo": mean - z * sem,
        "hi": mean + z * sem,
        "std": np.asarray(moments.std, dtype=np.float64),
        "sem": sem,
        "n": moments.count,
        "confidence": confidence,
    }
