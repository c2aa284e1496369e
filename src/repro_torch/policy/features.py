"""Online arrival features shared by the training kernels and the live wrapper
(port of ``repro.policy.features``).

The learned timeout policy sees the *same* online statistics the analytical
:class:`~repro_torch.core.adaptive.PolicyController` maintains — EWMA rate, EWMA
dispersion (CV/burstiness), plus a fast/slow regime posterior — so the two
controllers are comparable observation-for-observation.  Two implementations
of one recurrence live here:

* ``update_state`` / ``feature_vector`` — float64 torch tensors over any
  batch shape (streams, or population × streams), advanced once per gap by
  the training rollout's loop (:mod:`repro_torch.policy.rollout`);
* ``update_state_py`` / ``feature_vector_py`` — plain Python floats, run by
  the serving-side wrapper (:mod:`repro_torch.policy.controller`) once per
  request with no tensor dispatch on the hot path.

They must stay arithmetically identical (pinned by
``tests/test_torch_policy.py``): training/serving skew in the features
would silently shift every learned decision.

All six features are dimensionless and O(1): gaps are measured in units of
the item's ski-rental break-even time T*_be, so one trained network
transfers across workload items whose traffic shape (not scale) matches.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_F64 = torch.float64

#: EWMA constant of the mean-gap estimate (identical to PolicyController).
ALPHA_MEAN = 0.3
#: EWMA constant of the squared-deviation estimate (PolicyController's
#: ``var_alpha`` default: dispersion remembers 16x longer than the mean).
ALPHA_VAR = ALPHA_MEAN / 16.0
#: Fast regime posterior: EWMA of 1[gap < T*_be] over the last few gaps.
ALPHA_FAST = 0.5
#: Slow regime posterior: the same indicator at ~20-gap memory; the
#: fast/slow *pair* is what lets the network see regime switches (fast
#: moved, slow not yet) rather than just the current regime.
ALPHA_SLOW = 0.05
#: CV is clipped here before entering the network (MMPP streams can push
#: the raw estimate to ~10; everything above ~4 is "very bursty").
CV_CLIP = 4.0
#: Warmup feature saturates at this many observations.
N_WARMUP = 16.0

N_FEATURES = 6


class FeatureState(NamedTuple):
    """Carry of the online feature recurrence (floats or float64 tensors of
    one batch shape)."""

    mean_ms: torch.Tensor | float    # EWMA mean gap (ms); seeded by first gap
    var_ms2: torch.Tensor | float    # EWMA squared deviation (ms^2)
    p_fast: torch.Tensor | float     # fast posterior of 1[gap < T*_be]
    p_slow: torch.Tensor | float     # slow posterior of the same indicator
    last_ms: torch.Tensor | float    # most recent gap (ms)
    n: torch.Tensor | float          # observation count


def init_state() -> FeatureState:
    """Pre-observation state: posteriors at the uninformative 1/2."""
    return FeatureState(0.0, 0.0, 0.5, 0.5, 0.0, 0.0)


def init_state_tensor(shape=(), device="cpu") -> FeatureState:
    """:func:`init_state` as float64 tensors of ``shape`` on ``device``."""
    return FeatureState(
        *(torch.full(shape, x, dtype=_F64, device=device) for x in init_state())
    )


# ---- tensor recurrence (training kernels) -----------------------------------

def update_state(state: FeatureState, gap_ms, t_be_ms) -> FeatureState:
    """One observed inter-arrival gap -> next feature state, element-wise
    over the batch (``gap_ms`` broadcasts against the state)."""
    first = state.n < 0.5
    delta = gap_ms - state.mean_ms
    mean = torch.where(first, gap_ms, state.mean_ms + ALPHA_MEAN * delta)
    var = torch.where(
        first, 0.0, (1.0 - ALPHA_VAR) * state.var_ms2 + ALPHA_VAR * delta * delta
    )
    short = (gap_ms < t_be_ms).to(_F64)
    return FeatureState(
        mean_ms=mean,
        var_ms2=var,
        p_fast=state.p_fast + ALPHA_FAST * (short - state.p_fast),
        p_slow=state.p_slow + ALPHA_SLOW * (short - state.p_slow),
        last_ms=torch.broadcast_to(gap_ms, state.n.shape),
        n=state.n + 1.0,
    )


def feature_vector(state: FeatureState, t_be_ms) -> torch.Tensor:
    """``(..., N_FEATURES)`` network input; ``t_be_ms`` is a 0-d float64
    tensor on the state's device."""
    seen = state.n > 0.5
    mean = torch.where(seen, state.mean_ms, t_be_ms)
    last = torch.where(seen, state.last_ms, t_be_ms)
    cv = torch.sqrt(torch.clamp_min(state.var_ms2, 0.0)) / torch.clamp_min(mean, 1e-9)
    return torch.stack(
        [
            torch.log1p(last / t_be_ms),
            torch.log1p(mean / t_be_ms),
            torch.clamp_max(cv, CV_CLIP),
            2.0 * state.p_fast - 1.0,
            2.0 * state.p_slow - 1.0,
            torch.clamp_max(state.n, N_WARMUP) / (N_WARMUP / 2.0) - 1.0,
        ],
        dim=-1,
    )


# ---- Python-float recurrence (serving wrapper) ------------------------------

def update_state_py(state: FeatureState, gap_ms: float, t_be_ms: float) -> FeatureState:
    """Bit-compatible Python twin of :func:`update_state`."""
    first = state.n < 0.5
    delta = gap_ms - state.mean_ms
    mean = gap_ms if first else state.mean_ms + ALPHA_MEAN * delta
    var = 0.0 if first else (1.0 - ALPHA_VAR) * state.var_ms2 + ALPHA_VAR * delta * delta
    short = 1.0 if gap_ms < t_be_ms else 0.0
    return FeatureState(
        mean_ms=mean,
        var_ms2=var,
        p_fast=state.p_fast + ALPHA_FAST * (short - state.p_fast),
        p_slow=state.p_slow + ALPHA_SLOW * (short - state.p_slow),
        last_ms=gap_ms,
        n=state.n + 1.0,
    )


def feature_vector_py(state: FeatureState, t_be_ms: float) -> list:
    """Bit-compatible Python twin of :func:`feature_vector`."""
    seen = state.n > 0.5
    mean = state.mean_ms if seen else t_be_ms
    last = state.last_ms if seen else t_be_ms
    cv = math.sqrt(max(state.var_ms2, 0.0)) / max(mean, 1e-9)
    return [
        math.log1p(last / t_be_ms),
        math.log1p(mean / t_be_ms),
        min(cv, CV_CLIP),
        2.0 * state.p_fast - 1.0,
        2.0 * state.p_slow - 1.0,
        min(state.n, N_WARMUP) / (N_WARMUP / 2.0) - 1.0,
    ]
