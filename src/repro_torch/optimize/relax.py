"""Smooth, differentiable relaxation of the energy/lifetime closed forms
(port of ``repro.optimize.relax``; float64 torch tensors, autograd in
place of ``jax.grad``).

The paper's design space is a discrete grid: SPI buswidth ∈ {1, 2, 4}, SPI
clock ∈ Table 1, compression ∈ {off, on}, with the request-period and budget
axes continuous.  The closed forms themselves
(:mod:`repro_torch.core.batch_eval`'s kernels) are smooth in every
*continuous* quantity — the only non-differentiable pieces are (a) the
discrete choice axes and (b) the ``floor`` in Eq. 3.  This module relaxes
exactly those two:

* the **clock** becomes a continuous value in ``[min, max]`` of the legal
  grid, held there by a straight-through clip (the forward value never
  leaves the interval, the gradient is the identity);
* **buswidth** and **compression** become softmax distributions over their
  legal values; relaxed quantities are the *expectation* of the exact
  closed form over those distributions — linear in the probabilities, so
  the relaxation is **exact at every one-hot corner** (it passes through
  the true grid values, not an approximation of them);
* the Eq.-3 ``floor`` is dropped (:func:`~repro_torch.core.batch_eval.
  onoff_n_smooth` / :func:`~repro_torch.core.batch_eval.idlewait_n_smooth`)
  and hard feasibility tests (``T_req ≥ T_latency``) and the adaptive
  strategy's crossover selection become sigmoids with a sharpness scale.

The relaxed objective is for *search only*: after descent, parameters are
rounded back to the legal grid (:func:`snap`, or differentiably with
:func:`straight_through_round` / :func:`straight_through_onehot`), and every
rounded candidate is re-validated through the exact oracle — see
:mod:`repro_torch.optimize.descent`.

Every function here is element-wise over a leading batch of starts: a
parameter dict whose leaves carry a leading ``(S,)`` axis gives ``(S,)``
losses, and no operation mixes two starts, so one ``loss.sum().backward()``
gives every start its own gradient (what the reference's ``vmap`` of
``value_and_grad`` computes).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.batch_eval import (
    DeviceArrays,
    _div,
    config_phase_kernel,
    crossover_kernel,
    idle_energy_kernel,
    idlewait_n_smooth,
    onoff_n_smooth,
)
from repro_torch.core.config_phase import (
    COMPRESSION_OPTIONS,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    FpgaDevice,
)
from repro_torch.core.phases import CONFIGURATION, WorkloadItem, paper_lstm_item
from repro_torch.device import resolve_device

__all__ = [
    "RelaxedProblem",
    "init_params",
    "decode",
    "snap",
    "straight_through_round",
    "straight_through_onehot",
    "relaxed_config",
    "relaxed_counts",
    "config_energy_loss",
    "config_scalarized_loss",
    "lifetime_loss",
    "sigmoid_gate",
    "smooth_min",
]

_F64 = torch.float64

#: Sharpness (ms) of the sigmoid feasibility/crossover gates.  Small enough
#: that the gates are near-hard at grid resolution, large enough that useful
#: gradients survive a few ms away from the boundary.
DEFAULT_GATE_MS = 1.0


def sigmoid_gate(margin_ms, gate_ms=DEFAULT_GATE_MS):
    """Smooth indicator ``1[margin_ms > 0]`` with sharpness ``gate_ms``.

    The single gate every relaxation here uses (feasibility, crossover pick,
    and the policy trainer's release decision): exactly 0.5 at the boundary,
    within 1e-9 of hard past ``±21·gate_ms``, and monotone in the margin.
    """
    return torch.sigmoid(_div(margin_ms, gate_ms))


def smooth_min(a, b, gate_ms=DEFAULT_GATE_MS):
    """Differentiable ``min(a, b)`` with the same sharpness convention:
    ``a·σ((b−a)/s) + b·σ((a−b)/s)``, exact far from the kink.  Used by the
    learned-policy trainer for the idle-time term ``min(gap, timeout)`` of
    the per-gap energy."""
    w = torch.sigmoid(_div(b - a, gate_ms))
    return a * w + b * (1.0 - w)


def _scalar(x: float, device) -> torch.Tensor:
    return torch.full((), float(x), dtype=_F64, device=device)


@dataclasses.dataclass(frozen=True)
class RelaxedProblem:
    """Static problem data for the relaxed objectives.

    ``dev_cols`` is a :meth:`~repro_torch.core.batch_eval.DeviceArrays.cols`
    dict of 0-d float64 tensors on the run's device; the workload item's
    execution phases enter as the fixed scalars ``e_exec_mj``/``t_exec_ms``
    (configuration is what is being optimized, so it is *derived* from the
    knobs, exactly as :func:`repro_torch.core.batch_eval.sweep_batch`
    derives it per grid point).
    """

    dev_cols: Mapping[str, torch.Tensor]
    buswidths: tuple[int, ...]
    clocks_mhz: np.ndarray          # sorted f64 legal clocks (may be huge)
    e_exec_mj: float
    t_exec_ms: float
    request_period_ms: float
    e_budget_mj: float
    idle_power_mw: float
    powerup_overhead_mj: float
    gate_ms: float = DEFAULT_GATE_MS

    @staticmethod
    def from_device(
        device: FpgaDevice,
        item: WorkloadItem | None = None,
        buswidths: Sequence[int] = SPI_BUSWIDTHS,
        clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
        request_period_ms: float = 40.0,
        e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
        idle_power_mw: float | None = None,
        powerup_overhead_mj: float = 0.0,
        gate_ms: float = DEFAULT_GATE_MS,
        torch_device="cuda",
    ) -> "RelaxedProblem":
        """The problem of FPGA ``device`` running ``item``; its tensors live
        on ``torch_device`` (default the card)."""
        item = item if item is not None else paper_lstm_item()
        if not item.has_phase(CONFIGURATION):
            raise ValueError(
                "the relaxation derives the configuration phase from the device "
                f"model; item {item.name!r} must carry one to replace"
            )
        clocks = np.sort(np.asarray(clocks_mhz, dtype=np.float64))
        if clocks.size < 2:
            raise ValueError("need at least two legal clocks to span a continuous axis")
        on = resolve_device(torch_device)
        return RelaxedProblem(
            dev_cols=DeviceArrays.from_devices([device], on).reshape(()).cols(),
            buswidths=tuple(int(w) for w in buswidths),
            clocks_mhz=clocks,
            e_exec_mj=item.execution_energy_mj,
            t_exec_ms=item.execution_time_ms,
            request_period_ms=float(request_period_ms),
            e_budget_mj=float(e_budget_mj),
            idle_power_mw=float(
                item.idle_power_mw if idle_power_mw is None else idle_power_mw
            ),
            powerup_overhead_mj=float(powerup_overhead_mj),
            gate_ms=float(gate_ms),
        )

    @property
    def torch_device(self) -> torch.device:
        return self.dev_cols["bitstream_bits"].device

    @property
    def clock_bounds(self) -> tuple[float, float]:
        return float(self.clocks_mhz[0]), float(self.clocks_mhz[-1])


# ---------------------------------------------------------------------------
# Parameterization: unconstrained ℝ^d ↔ (clock, buswidth probs, compression p)
# ---------------------------------------------------------------------------
def init_params(generator: torch.Generator, problem: RelaxedProblem, n_starts: int) -> dict:
    """Random multi-start parameters, each leaf with leading axis (S,), drawn
    from ``generator`` and placed on the problem's device.

    Clock raw values spread uniformly over the legal interval; choice
    logits start small so the softmaxes begin near-uniform (no corner is
    favoured before the gradients speak).  The reference draws from
    ``jax.random``; the law is the same, the numbers are not.
    """
    lo, hi = problem.clock_bounds
    on = problem.torch_device
    g = generator
    u = torch.rand((n_starts,), generator=g, dtype=_F64, device=g.device)
    params = {
        "f_raw": lo + (hi - lo) * u,
        "w_logits": 0.3 * torch.randn((n_starts, len(problem.buswidths)), generator=g,
                                      dtype=_F64, device=g.device),
        "c_logits": 0.3 * torch.randn((n_starts, len(COMPRESSION_OPTIONS)), generator=g,
                                      dtype=_F64, device=g.device),
    }
    return {k: v.to(on) for k, v in params.items()}


def decode(params: dict, problem: RelaxedProblem) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unconstrained params → (clock MHz, buswidth probs, P[compression]).

    The clock is a straight-through clip onto the legal ``[min, max]``
    interval: the forward value never leaves it, while the gradient is the
    identity everywhere — so a boundary optimum (the common case: faster
    loading is cheaper) is reached *exactly* in finitely many steps, where
    a sigmoid map would only approach it asymptotically and leave the
    snapped clock several grid steps short on a dense axis.
    """
    return _decode_core(params, leaves(problem))


def snap(params: dict, problem: RelaxedProblem) -> dict:
    """Round to the legal grid: nearest legal clock, argmax choices.

    Returns plain numpy values — candidates for exact re-validation.
    """
    with torch.no_grad():
        f, w_probs, c_prob = decode(params, problem)
    clocks = np.asarray(problem.clocks_mhz)
    f = f.cpu().numpy()
    idx = nearest_clock_index(f, clocks)
    return {
        "clock_mhz": clocks[idx],
        "buswidth": np.asarray(problem.buswidths)[np.argmax(w_probs.cpu().numpy(), axis=-1)],
        "compression": c_prob.cpu().numpy() > 0.5,
    }


def nearest_clock_index(f: np.ndarray, clocks: np.ndarray) -> np.ndarray:
    """Index of the nearest legal clock per value — O(log n) searchsorted,
    so snapping stays cheap on million-point densified axes."""
    pos = np.clip(np.searchsorted(clocks, f), 1, clocks.size - 1)
    left = clocks[pos - 1]
    right = clocks[pos]
    return np.where(np.abs(f - left) <= np.abs(right - f), pos - 1, pos)


def straight_through_round(x: torch.Tensor, grid) -> torch.Tensor:
    """Snap ``x`` to the nearest grid value in the forward pass while
    gradients flow through the continuous value (the straight-through
    estimator): ``x + (snap(x) − x).detach()``."""
    g = torch.as_tensor(grid, dtype=x.dtype, device=x.device)
    snapped = g[torch.argmin(torch.abs(x[..., None] - g), dim=-1)]
    return x + (snapped - x).detach()


def straight_through_onehot(logits: torch.Tensor) -> torch.Tensor:
    """One-hot(argmax) forward, softmax gradients backward."""
    soft = torch.softmax(logits, dim=-1)
    hard = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]
    ).to(soft.dtype)
    return soft + (hard - soft).detach()


# ---------------------------------------------------------------------------
# Relaxed closed forms.  Core functions take the problem as (leaves,
# n_buswidths): ``leaves`` is a dict of 0-d float64 tensors (device columns
# + workload/operating-point constants), so one descent loop serves every
# device, grid and operating point.
# ---------------------------------------------------------------------------
def leaves(problem: RelaxedProblem) -> dict:
    """The problem's numeric content as a flat dict of 0-d float64 tensors
    on its device."""
    on = problem.torch_device
    s = lambda x: _scalar(x, on)  # noqa: E731
    return {
        "dev": dict(problem.dev_cols),
        "e_exec_mj": s(problem.e_exec_mj),
        "t_exec_ms": s(problem.t_exec_ms),
        "t_req_ms": s(problem.request_period_ms),
        "budget_mj": s(problem.e_budget_mj),
        "p_idle_mw": s(problem.idle_power_mw),
        "powerup_mj": s(problem.powerup_overhead_mj),
        "gate_ms": s(problem.gate_ms),
        "f_lo": s(problem.clock_bounds[0]),
        "f_hi": s(problem.clock_bounds[1]),
        "buswidths": torch.as_tensor(problem.buswidths, dtype=_F64, device=on),
    }


def _decode_core(params: dict, lv: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raw = params["f_raw"]
    f = raw + (torch.clamp(raw, lv["f_lo"], lv["f_hi"]) - raw).detach()
    w_probs = torch.softmax(params["w_logits"], dim=-1)
    c_prob = torch.softmax(params["c_logits"], dim=-1)[..., 1]
    return f, w_probs, c_prob


def _config_core(lv: dict, f, w_probs, c_prob, n_w: int):
    e = torch.zeros(f.shape, dtype=_F64, device=f.device)
    t = torch.zeros(f.shape, dtype=_F64, device=f.device)
    zero, one = _scalar(0.0, f.device), _scalar(1.0, f.device)
    for i in range(n_w):
        w = lv["buswidths"][i]
        for cval, pc in ((zero, 1.0 - c_prob), (one, c_prob)):
            out = config_phase_kernel(lv["dev"], w + 0.0 * f, f, cval)
            weight = w_probs[..., i] * pc
            e = e + weight * out["config_energy_mj"]
            t = t + weight * out["config_time_ms"]
    return e, t


def _counts_core(lv: dict, f, w_probs, c_prob, n_w: int) -> dict[str, torch.Tensor]:
    e_cfg, t_cfg = _config_core(lv, f, w_probs, c_prob, n_w)
    t_req = lv["t_req_ms"]
    budget = lv["budget_mj"]
    p_idle = lv["p_idle_mw"]
    gate = lambda margin_ms: sigmoid_gate(margin_ms, lv["gate_ms"])  # noqa: E731

    e_onoff = e_cfg + lv["e_exec_mj"] + lv["powerup_mj"]
    t_onoff = t_cfg + lv["t_exec_ms"]
    n_onoff = onoff_n_smooth(e_onoff, budget) * gate(t_req - t_onoff)

    e_idle = idle_energy_kernel(p_idle, t_req, lv["t_exec_ms"])
    e_init = e_cfg + lv["powerup_mj"]
    n_iw = idlewait_n_smooth(e_init, lv["e_exec_mj"], e_idle, budget)
    n_iw = n_iw * gate(t_req - lv["t_exec_ms"])

    cross = crossover_kernel(e_onoff, lv["e_exec_mj"], lv["t_exec_ms"], p_idle)
    pick_iw = gate(cross - t_req)
    n_adaptive = pick_iw * n_iw + (1.0 - pick_iw) * n_onoff
    return {
        "config_energy_mj": e_cfg,
        "config_time_ms": t_cfg,
        "onoff_n": n_onoff,
        "iw_n": n_iw,
        "adaptive_n": n_adaptive,
        "crossover_ms": cross,
        "pick_iw": pick_iw,
        "lifetime_ms": n_adaptive * t_req,
    }


# loss cores: (params, leaves, n_buswidths, lam) → (S,) or ().  ``lam`` is
# only read by the scalarized objective; the uniform signature lets descent
# run one loop for all three.
def config_energy_core(params: dict, lv: dict, n_w: int, lam) -> torch.Tensor:
    f, w_probs, c_prob = _decode_core(params, lv)
    e, _ = _config_core(lv, f, w_probs, c_prob, n_w)
    return e


def config_scalarized_core(params: dict, lv: dict, n_w: int, lam) -> torch.Tensor:
    f, w_probs, c_prob = _decode_core(params, lv)
    e, t = _config_core(lv, f, w_probs, c_prob, n_w)
    worst = config_phase_kernel(lv["dev"], lv["buswidths"][0], lv["f_lo"], _scalar(0.0, f.device))
    return lam * e / worst["config_energy_mj"] + (1.0 - lam) * t / worst["config_time_ms"]


def lifetime_core(params: dict, lv: dict, n_w: int, lam) -> torch.Tensor:
    return -_counts_core(lv, *_decode_core(params, lv), n_w)["lifetime_ms"]


# ---------------------------------------------------------------------------
# Public problem-level API (wrappers over the cores)
# ---------------------------------------------------------------------------
def relaxed_config(
    problem: RelaxedProblem,
    f: torch.Tensor,
    w_probs: torch.Tensor,
    c_prob: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expected (config energy mJ, config time ms) over the discrete choice
    distributions, at continuous clock ``f``.

    The expectation runs the *exact* kernel at every (buswidth, compression)
    combination — |W|·2 evaluations, linear in the probabilities — so at a
    one-hot corner the relaxed value IS the exact grid value.
    """
    return _config_core(leaves(problem), f, w_probs, c_prob, len(problem.buswidths))


def relaxed_counts(
    problem: RelaxedProblem,
    f: torch.Tensor,
    w_probs: torch.Tensor,
    c_prob: torch.Tensor,
) -> dict[str, torch.Tensor]:
    """Every relaxed Eq.-1–4 quantity at one (relaxed) configuration.

    Feasibility (``T_req ≥ T_latency``) and the adaptive crossover pick
    become sigmoid gates of width :attr:`RelaxedProblem.gate_ms`; item
    counts are the pre-floor closed forms.
    """
    return _counts_core(leaves(problem), f, w_probs, c_prob, len(problem.buswidths))


def config_energy_loss(params: dict, problem: RelaxedProblem) -> torch.Tensor:
    """Experiment 1's objective: expected configuration energy (mJ)."""
    return config_energy_core(params, leaves(problem), len(problem.buswidths), 0.0)


def config_scalarized_loss(params: dict, problem: RelaxedProblem, lam) -> torch.Tensor:
    """λ-scalarization of (energy, time) for tracing the config Pareto
    frontier by descent: ``λ·E/E₀ + (1−λ)·T/T₀``, normalized by the
    worst-corner scales so λ spans the front evenly."""
    lam = torch.as_tensor(lam, dtype=_F64, device=problem.torch_device)
    return config_scalarized_core(params, leaves(problem), len(problem.buswidths), lam)


def lifetime_loss(params: dict, problem: RelaxedProblem) -> torch.Tensor:
    """Negative relaxed adaptive lifetime (maximize items served within the
    budget at the problem's request period — Eqs. 3–4 with the crossover
    rule deciding the strategy arm per configuration)."""
    return lifetime_core(params, leaves(problem), len(problem.buswidths), 0.0)


#: Loss cores by name — the registry :mod:`repro_torch.optimize.descent`
#: runs its loops from.
LOSS_CORES = {
    "config_energy": config_energy_core,
    "config_scalarized": config_scalarized_core,
    "adaptive_lifetime": lifetime_core,
}
