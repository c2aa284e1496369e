"""Delta-method error propagation through the differentiable closed forms
(port of ``repro.mc.sensitivity``).

The repo's headline constants are smooth functions of measured hardware
quantities (idle power, phase energies/times, SPI power coefficients), and
:mod:`repro_torch.core.batch_eval` exposes those functions as
differentiable tensor primitives
(:func:`~repro_torch.core.batch_eval.crossover_kernel`,
:func:`~repro_torch.core.batch_eval.config_phase_kernel`, the smooth Eq.-3
counts).  That makes first-order uncertainty propagation one float64
``torch.autograd.grad`` call away (the reference's ``jax.grad``): for
measurement noise σ_i on parameter θ_i,

    Var[f(θ)] ≈ Σ_i (∂f/∂θ_i · σ_i)²                    (delta method)

This module computes those analytic bands and — the part that makes them
trustworthy — **cross-validates them against empirical Monte Carlo bands**
obtained by pushing the *same* jittered parameters through the *exact*
kernels (:func:`cross_validate`).  At small relative jitter the two must
agree to within the second-order error (a few percent); a large gap means
the linearization is out of its regime and only the MC band should be
quoted.

All samplers draw relative Gaussian noise, ``θ · (1 + jitter · ε)``, the
natural model for calibrated-measurement error; at ``jitter = 0`` every
sample equals the nominal value bit-for-bit, so the deterministic headline
numbers (499.06 ms, 12.39×, 40.13×/11.85 mJ) are recovered exactly.
The draws are numpy's ``default_rng``, as in the reference, so both
packages see the same parameters; the kernels run on ``device`` (the card
by default, ``"cpu"`` on the host).
"""
from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.batch_eval import (
    config_phase_kernel,
    crossover_kernel,
    evaluate_idlewait_batch,
    evaluate_onoff_batch,
    grid_axes,
    idle_energy_kernel,
    idlewait_n_smooth,
    onoff_n_smooth,
)
from repro_torch.core.config_phase import (
    COMPRESSION_OPTIONS,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    SPARTAN7_XC7S15,
    FpgaDevice,
)
from repro_torch.core.phases import WorkloadItem, paper_lstm_item
from repro_torch.device import resolve_device

_F64 = torch.float64

__all__ = [
    "jittered_params",
    "delta_method",
    "crossover_uncertainty",
    "lifetime_ratio_uncertainty",
    "energy_per_request_uncertainty",
    "config_energy_uncertainty",
    "cross_validate",
]

#: FpgaDevice fields subject to measurement noise (power/time calibrations).
#: ``bitstream_bits`` and ``compression_ratio`` are exact file properties.
_DEVICE_MEASURED = (
    "setup_time_ms",
    "setup_power_mw",
    "p_static_load_mw",
    "k_io_mw_per_lane_mhz",
    "k_comp_mw_per_lane_mhz",
)


def jittered_params(
    nominal: Mapping[str, float], jitter: float, n_seeds: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """S relative-Gaussian draws per parameter: ``θ · (1 + jitter · ε)``.

    Draws are clipped at a tiny positive floor (the measured quantities are
    all physically positive); for ``jitter ≲ 0.1`` the clip never fires.
    ``jitter = 0`` returns the nominal values exactly, S times.
    """
    if not (math.isfinite(jitter) and jitter >= 0):
        raise ValueError(f"jitter must be a finite, non-negative fraction, got {jitter!r}")
    if n_seeds <= 0:
        raise ValueError(f"n_seeds must be positive, got {n_seeds}")
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in nominal.items():
        eps = rng.standard_normal(n_seeds)
        out[k] = np.maximum(v * (1.0 + jitter * eps), 1e-12 * abs(v) + 1e-300)
    return out


def delta_method(
    fn: Callable[[Mapping[str, torch.Tensor]], torch.Tensor],
    nominal: Mapping[str, float],
    jitter: float,
    sigmas: Mapping[str, float] | None = None,
    device="cuda",
) -> tuple[float, float]:
    """First-order propagated ``(value, std)`` of ``fn`` at ``nominal``.

    ``fn`` maps a dict of float64 0-d tensors (on ``device``) to a scalar
    tensor (any of the repo's differentiable primitives, or a composition);
    ``sigmas`` defaults to relative noise ``jitter · |θ_i|`` on every
    parameter.
    """
    device = resolve_device(device)
    params = {k: torch.tensor(float(v), dtype=_F64, device=device, requires_grad=True)
              for k, v in nominal.items()}
    out = fn(params)
    value = float(out.detach())
    grads = dict(zip(params, torch.autograd.grad(out, list(params.values()), allow_unused=True)))
    grads = {k: 0.0 if g is None else g for k, g in grads.items()}
    if sigmas is None:
        sigmas = {k: jitter * abs(float(v)) for k, v in nominal.items()}
    var = sum(float(grads[k]) ** 2 * float(sigmas[k]) ** 2 for k in nominal)
    return value, math.sqrt(var)


def cross_validate(samples, delta_std: float, confidence: float = 0.95) -> dict:
    """Empirical (MC) band vs analytic (delta) band for the same jitter.

    Both half-widths are CLT bands for the mean over the same S, so their
    ratio is exactly the std ratio; ``rel_disagreement`` is the headline
    agreement figure (≲ 0.1 expected at small jitter).
    """
    from repro_torch.mc.intervals import z_value

    s = np.asarray(samples, dtype=np.float64).ravel()
    s = s[np.isfinite(s)]
    if s.size < 2:
        mc_std = 0.0
    else:
        mc_std = float(s.std(ddof=1))
    z = z_value(confidence)
    n = max(int(s.size), 1)
    if delta_std > 0:
        rel = abs(mc_std - delta_std) / delta_std
    else:
        rel = 0.0 if mc_std == 0.0 else math.inf
    return {
        "mc_std": mc_std,
        "delta_std": delta_std,
        "rel_disagreement": rel,
        "mc_half_width": z * mc_std / math.sqrt(n),
        "delta_half_width": z * delta_std / math.sqrt(n),
        "n": int(s.size),
        "confidence": confidence,
    }


# ---------------------------------------------------------------------------
# Headline quantities
# ---------------------------------------------------------------------------
def _crossover_nominal(item, idle_power_mw, powerup_overhead_mj) -> dict[str, float]:
    p_idle = item.idle_power_mw if idle_power_mw is None else idle_power_mw
    return {
        "e_onoff": em.onoff_item_energy_mj(item, powerup_overhead_mj),
        "e_exec": em.idlewait_item_energy_mj(item),
        "t_exec": em.idlewait_latency_ms(item),
        "p_idle": p_idle,
    }


def _crossover_fn(p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return crossover_kernel(p["e_onoff"], p["e_exec"], p["t_exec"], p["p_idle"])


def crossover_uncertainty(
    item: WorkloadItem | None = None,
    jitter: float = 0.02,
    n_seeds: int = 1024,
    seed: int = 0,
    idle_power_mw: float | None = 24.0,
    powerup_overhead_mj: float = em.CALIBRATED_POWERUP_OVERHEAD_MJ,
    device="cuda",
) -> dict:
    """MC samples + delta band for the Idle-Waiting/On-Off crossover period.

    The nominal value is :func:`repro_torch.core.energy_model.crossover_period_ms`
    bit-for-bit (the kernel is the same IEEE-754 expression); the default
    arguments are the paper's Methods-1+2 operating point, 499.06 ms.
    """
    device = resolve_device(device)
    item = item if item is not None else paper_lstm_item()
    nominal = _crossover_nominal(item, idle_power_mw, powerup_overhead_mj)
    draws = jittered_params(nominal, jitter, n_seeds, seed)
    cols = {k: torch.as_tensor(v, dtype=_F64).to(device) for k, v in draws.items()}
    samples = crossover_kernel(
        cols["e_onoff"], cols["e_exec"], cols["t_exec"], cols["p_idle"]
    ).cpu().numpy()
    value, dstd = delta_method(_crossover_fn, nominal, jitter, device=device)
    return {
        "nominal_ms": value,
        "samples": samples,
        "delta_std": dstd,
        "jitter": jitter,
        "params": dict(nominal),
    }


def lifetime_ratio_uncertainty(
    item: WorkloadItem | None = None,
    jitter: float = 0.02,
    n_seeds: int = 1024,
    seed: int = 0,
    request_period_ms: float = 40.0,
    idle_power_mw: float = 24.0,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = em.CALIBRATED_POWERUP_OVERHEAD_MJ,
    device="cuda",
) -> dict:
    """MC samples + delta band for the Idle-Waiting/On-Off lifetime ratio
    (the paper's 12.39× at 40 ms / 4147 J).

    MC pushes jittered (period, idle power) through the **exact** batch
    evaluators — integer Eq.-3 counts, the floored truth — while the delta
    band propagates through the smooth pre-floor counts
    (:func:`~repro_torch.core.batch_eval.idlewait_n_smooth` /
    :func:`~repro_torch.core.batch_eval.onoff_n_smooth`); at the paper's
    operating point the floor quantization is ~1e-6 relative, far below the
    band.
    """
    device = resolve_device(device)
    item = item if item is not None else paper_lstm_item()
    nominal = {"t_req": request_period_ms, "p_idle": idle_power_mw}
    draws = jittered_params(nominal, jitter, n_seeds, seed)
    iw = evaluate_idlewait_batch(
        item, draws["t_req"], e_budget_mj, idle_powers_mw=draws["p_idle"],
        powerup_overhead_mj=powerup_overhead_mj, device=device,
    )
    oo = evaluate_onoff_batch(
        item, draws["t_req"], e_budget_mj, powerup_overhead_mj=powerup_overhead_mj,
        device=device,
    )
    oo_n, iw_n = oo.n_max.cpu().numpy(), iw.n_max.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        samples = np.where(
            (oo_n > 0) & iw.feasible.cpu().numpy() & oo.feasible.cpu().numpy(),
            iw_n / np.maximum(oo_n, 1),
            np.nan,
        ).astype(np.float64)

    e_exec = em.idlewait_item_energy_mj(item)
    t_exec = em.idlewait_latency_ms(item)
    e_init = em.idlewait_init_energy_mj(item, powerup_overhead_mj)
    e_onoff = em.onoff_item_energy_mj(item, powerup_overhead_mj)

    def ratio_fn(p):
        e_idle = idle_energy_kernel(p["p_idle"], p["t_req"], t_exec)
        n_iw = idlewait_n_smooth(e_init, e_exec, e_idle, e_budget_mj)
        n_oo = onoff_n_smooth(torch.tensor(e_onoff, dtype=_F64, device=device), e_budget_mj)
        return n_iw / n_oo

    value, dstd = delta_method(ratio_fn, nominal, jitter, device=device)
    exact_ratio = float(
        em.idlewait_n_max(item, request_period_ms, e_budget_mj, idle_power_mw,
                          powerup_overhead_mj)
        / em.onoff_n_max(item, e_budget_mj, powerup_overhead_mj)
    )
    return {
        "nominal": exact_ratio,
        "nominal_smooth": value,
        "samples": samples,
        "delta_std": dstd,
        "n_degenerate": int(np.sum(~np.isfinite(samples))),
        "jitter": jitter,
    }


def energy_per_request_uncertainty(
    item: WorkloadItem | None = None,
    jitter: float = 0.02,
    n_seeds: int = 1024,
    seed: int = 0,
    request_period_ms: float = 40.0,
    idle_power_mw: float = 24.0,
    powerup_overhead_mj: float = em.CALIBRATED_POWERUP_OVERHEAD_MJ,
    device="cuda",
) -> dict:
    """MC samples + delta band for Idle-Waiting marginal energy per request
    (execution + realized idle span) at the paper's operating point."""
    device = resolve_device(device)
    item = item if item is not None else paper_lstm_item()
    nominal = {"t_req": request_period_ms, "p_idle": idle_power_mw}
    draws = jittered_params(nominal, jitter, n_seeds, seed)
    iw = evaluate_idlewait_batch(
        item, draws["t_req"], em.PAPER_ENERGY_BUDGET_MJ,
        idle_powers_mw=draws["p_idle"], powerup_overhead_mj=powerup_overhead_mj,
        device=device,
    )
    samples = np.where(iw.feasible.cpu().numpy(), iw.energy_per_item_mj.cpu().numpy(),
                       np.nan).astype(np.float64)
    e_exec = em.idlewait_item_energy_mj(item)
    t_exec = em.idlewait_latency_ms(item)

    def epr_fn(p):
        return e_exec + idle_energy_kernel(p["p_idle"], p["t_req"], t_exec)

    value, dstd = delta_method(epr_fn, nominal, jitter, device=device)
    return {
        "nominal_mj": value,
        "samples": samples,
        "delta_std": dstd,
        "n_degenerate": int(np.sum(~np.isfinite(samples))),
        "jitter": jitter,
    }


def config_energy_uncertainty(
    device: FpgaDevice = SPARTAN7_XC7S15,
    jitter: float = 0.02,
    n_seeds: int = 1024,
    seed: int = 0,
    torch_device: str | torch.device = "cuda",
) -> dict:
    """MC samples + delta bands for Experiment 1's two headline numbers —
    the 11.85 mJ best-configuration energy and the 40.13× worst/best
    reduction — under measurement noise on the device's power/time
    calibrations, propagated through
    :func:`~repro_torch.core.batch_eval.config_phase_kernel` over the full
    Table-1 grid per seed.  ``device`` is the FPGA (the reference's
    argument); ``torch_device`` is where the grid runs (the card by
    default)."""
    on = resolve_device(torch_device)
    measured = {f: float(getattr(device, f)) for f in _DEVICE_MEASURED}
    exact = {
        "bitstream_bits": float(device.bitstream_bits),
        "compression_ratio": float(device.compression_ratio),
    }
    draws = jittered_params(measured, jitter, n_seeds, seed)
    w, f, c = grid_axes(
        SPI_BUSWIDTHS, SPI_CLOCKS_MHZ, [1.0 * bool(x) for x in COMPRESSION_OPTIONS], device=on
    )
    w, f, c = w[None], f[None], c[None]          # prepend seed axis
    cols = {k: torch.as_tensor(v, dtype=_F64).to(on).reshape(-1, 1, 1, 1) for k, v in draws.items()}
    cols.update({k: torch.tensor(v, dtype=_F64, device=on) for k, v in exact.items()})
    e = config_phase_kernel(cols, w, f, c)["config_energy_mj"]
    e = torch.broadcast_to(e, (n_seeds,) + tuple(e.shape[1:]))
    e_min = torch.amin(e, dim=(1, 2, 3)).cpu().numpy()
    e_max = torch.amax(e, dim=(1, 2, 3)).cpu().numpy()

    def grid_energy(p):
        full = {**{k: torch.tensor(v, dtype=_F64, device=on) for k, v in exact.items()}, **p}
        return config_phase_kernel(full, w[0], f[0], c[0])["config_energy_mj"]

    min_val, min_std = delta_method(lambda p: torch.min(grid_energy(p)), measured, jitter,
                                    device=on)
    ratio_val, ratio_std = delta_method(
        lambda p: torch.max(grid_energy(p)) / torch.min(grid_energy(p)), measured, jitter,
        device=on,
    )
    return {
        "min_energy": {
            "nominal_mj": min_val,
            "samples": e_min,
            "delta_std": min_std,
        },
        "reduction_ratio": {
            "nominal": ratio_val,
            "samples": e_max / e_min,
            "delta_std": ratio_std,
        },
        "jitter": jitter,
    }
