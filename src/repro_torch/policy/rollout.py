"""Vectorized policy rollouts: the trace simulator as one loop over gaps
(port of ``repro.policy.rollout``).

``rollout`` replays the *exact* discrete-event semantics of
:func:`repro_torch.core.simulator.simulate_trace` — queueing at the previous
completion, strict ``timeout < gap`` release, inline reconfiguration delay,
pre-staged initial configuration, and the budget admission epsilon — for a
whole batch of arrival streams at once, with the idle timeout chosen per
gap by the policy network over the online features.  The reference runs a
``vmap``-ped ``lax.scan``; here the carry is a set of float64 tensors of
shape (P, N) — a population of P networks (one for a plain rollout, one per
perturbation in evolution strategies) over N streams — advanced by a Python
loop over the gap index.  The features and the network's timeouts do not
depend on the dynamics, so they are evaluated for a block of gaps at once
ahead of the loop (for a whole training run, once: :func:`feature_sequence`).
``tests/test_torch_policy.py`` pins agreement (item counts exact, energies
within 1e-9) against the scalar simulator and the reference.

The same loop carries a *smooth* energy accumulator (``smooth=True``): the
hard ``min(gap, timeout)`` idle term and the 0/1 release indicator are
replaced by :func:`repro_torch.optimize.relax.smooth_min` and
:func:`repro_torch.optimize.relax.sigmoid_gate` at sharpness ``smooth_ms``,
so the accumulated energy is differentiable in the network parameters while
the *dynamics* (queueing, admission) stay hard.  Backprop trains on the
smooth total; antithetic ES (:mod:`repro_torch.policy.train`) trains on the
hard one, closing the relaxation bias on the routed path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.adaptive import break_even_timeout_ms
from repro_torch.core.phases import WorkloadItem
from repro_torch.core.strategies import IDLE_POWER_MW, IdlePowerMethod
from repro_torch.device import resolve_device
from repro_torch.optimize.relax import sigmoid_gate, smooth_min
from repro_torch.policy import features as F
from repro_torch.policy import net as N

#: Default sharpness (ms) of the smooth release gate / idle kink, as a
#: fraction of T*_be — wide enough that gradients reach the network from a
#: decision boundary half a break-even time away.
DEFAULT_SMOOTH_FRAC = 0.1

_ADMIT_EPS = 1e-9  # simulate_trace's budget admission epsilon
_F64 = torch.float64


def idle_power_for(item: WorkloadItem, method: IdlePowerMethod) -> float:
    """The idle-power convention of PolicyController.idle_power_mw."""
    if method is IdlePowerMethod.BASELINE:
        return item.idle_power_mw
    return IDLE_POWER_MW[method]


def make_consts(
    item: WorkloadItem,
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    powerup_overhead_mj: float = 0.0,
    budget_mj: float = math.inf,
    smooth_ms: float | None = None,
) -> dict:
    """Scalar physics constants of one workload item as a dict of floats.

    ``budget_mj=inf`` is the training setting — admission never trips and
    the objective is pure energy rate.
    """
    p_idle = idle_power_for(item, method)
    t_be = break_even_timeout_ms(item, p_idle, powerup_overhead_mj)
    if not (math.isfinite(t_be) and t_be > 0):
        raise ValueError(
            f"degenerate break-even timeout {t_be!r} ms for item "
            f"{item.name!r}: the learned policy needs a finite, positive "
            "ski-rental scale to normalise against"
        )
    return {
        "e_exec": float(item.execution_energy_mj),
        "t_exec": float(item.execution_time_ms),
        "e_config": float(item.config_energy_mj + powerup_overhead_mj),
        # overhead share of e_config, so the energy ledger can report the
        # power-up ramp separately from the configure phase
        "e_overhead": float(powerup_overhead_mj),
        "t_config": float(item.config_time_ms),
        "p_idle": float(p_idle),
        "t_be": float(t_be),
        "budget": float(budget_mj),
        "smooth_ms": float(
            smooth_ms if smooth_ms is not None else DEFAULT_SMOOTH_FRAC * t_be
        ),
    }


def _const_tensors(consts: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=_F64).to(device) for k, v in consts.items()}


def _population(params) -> list:
    """``params`` with a leading population axis on every leaf (P = 1 for a
    single network)."""
    if params[0]["w"].dim() == 3:
        return params
    return [{k: v[None] for k, v in layer.items()} for layer in params]


def _features(fs, gaps: torch.Tensor, t0: int, t1: int, t_be) -> tuple:
    """The feature recurrence continued from ``fs`` (the state before gap
    ``t0``'s decision) over the decisions of gaps ``t0 … t1−1``: decision t
    follows the observation of gap t−1 → (state, ``(N, t1−t0, F)``)."""
    rows = []
    for t in range(t0, t1):
        if t > 0:
            fs = F.update_state(fs, gaps[:, t - 1], t_be)
        rows.append(F.feature_vector(fs, t_be))
    if not rows:
        return fs, gaps.new_zeros((gaps.shape[0], 0, F.N_FEATURES))
    return fs, torch.stack(rows, dim=1)


def feature_sequence(gaps: torch.Tensor, t_be_ms) -> torch.Tensor:
    """``(N, T, N_FEATURES)`` network inputs of a gap batch: row t is the
    feature vector after observing gaps ``0 … t−1`` (row 0 the
    pre-observation state), i.e. the input of the timeout that manages the
    idle span before arrival t+1.  They depend on the gaps alone, so a
    training run computes them once for all its rollouts."""
    t_be = torch.as_tensor(t_be_ms, dtype=_F64).to(gaps.device)
    fs = F.init_state_tensor(gaps.shape[:1], gaps.device)
    return _features(fs, gaps, 0, gaps.shape[1], t_be)[1]


#: Elements of the widest network activation over a block of gaps: the
#: timeouts of ``_BLOCK // (P · N · width)`` gaps are evaluated at once.
_BLOCK = 1 << 25


def _rollout_batch(params, gaps: torch.Tensor, c: dict, smooth: bool, feats=None) -> dict:
    """Every (network, stream) pair of a population through the trace-
    simulator semantics: ``params`` with a leading (P,) axis, ``gaps`` of
    shape (N, T), ``c`` the constants as 0-d tensors on the gaps' device,
    ``feats`` the gaps' :func:`feature_sequence` when already computed →
    per-(P, N) float64 results.

    The timeouts depend on the network and the features only, never on the
    dynamics, so they are evaluated a block of gaps at a time (one batched
    matmul a layer); the loop over gaps then carries the dynamics alone."""
    params = _population(params)
    n_pop, (n_streams, n_gaps) = params[0]["w"].shape[0], gaps.shape
    shape, dev = (n_pop, n_streams), gaps.device
    width = max(layer["w"].shape[-1] for layer in params)
    block = max(1, min(n_gaps, _BLOCK // (n_pop * n_streams * max(width, F.N_FEATURES))))
    k1000 = torch.full((), 1000.0, dtype=_F64, device=dev)
    zero = torch.zeros(shape, dtype=_F64, device=dev)
    e_init = c["e_config"] + c["e_exec"]
    admit0 = e_init <= c["budget"] + _ADMIT_EPS * torch.clamp_min(e_init, 1.0)
    admit0_f = admit0.to(_F64)

    completion = zero + torch.where(admit0, c["t_exec"], 0.0)
    alive = torch.broadcast_to(admit0, shape)
    energy = zero + torch.where(admit0, e_init, 0.0)
    energy_smooth = None
    n = zero + admit0_f
    releases = zero
    configs = zero + admit0_f
    idle_mj = zero
    lifetime = completion
    arrival = zero
    fs = F.init_state_tensor((n_streams,), dev)

    for t0 in range(0, n_gaps, block):
        t1 = min(n_gaps, t0 + block)
        if feats is None:
            fs, x = _features(fs, gaps, t0, t1, c["t_be"])
        else:
            x = feats[:, t0:t1]
        taus = N.timeout_ms(params, x.reshape(1, -1, F.N_FEATURES), c["t_be"])
        taus = taus.reshape(n_pop, n_streams, t1 - t0).unbind(-1)
        if energy_smooth is None:
            energy_smooth = e_init + 0.0 * taus[0]

        for t in range(t0, t1):
            tau = taus[t - t0]
            a_new = arrival + gaps[:, t]
            start = torch.maximum(a_new, completion)
            gap_m = start - completion

            idle_t = torch.minimum(gap_m, tau)
            released = tau < gap_m
            idle_e = c["p_idle"] * idle_t / k1000
            cost = idle_e + torch.where(released, c["e_config"], 0.0) + c["e_exec"]
            admit = alive & (
                energy + cost <= c["budget"] + _ADMIT_EPS * torch.clamp_min(cost, 1.0)
            )
            energy = energy + torch.where(admit, cost, 0.0)
            start2 = start + torch.where(released, c["t_config"], 0.0)
            completion = torch.where(admit, start2 + c["t_exec"], completion)

            if smooth:
                s = c["smooth_ms"]
                rel_g = sigmoid_gate(gap_m - tau, s)
                cost_s = (
                    c["p_idle"] * smooth_min(gap_m, tau, s) / k1000
                    + rel_g * c["e_config"]
                    + c["e_exec"]
                )
                energy_smooth = energy_smooth + cost_s

            admit_f = admit.to(_F64)
            rel_f = (admit & released).to(_F64)
            alive = admit
            n = n + admit_f
            releases = releases + rel_f
            configs = configs + rel_f
            # the idle-waiting share of the same accumulation (ledger axis)
            idle_mj = idle_mj + torch.where(admit, idle_e, 0.0)
            lifetime = torch.where(admit, completion, lifetime)
            arrival = a_new

    if energy_smooth is None:       # no gaps: the initial configuration only
        energy_smooth = zero + e_init
    return {
        "energy_mj": energy,
        "energy_smooth_mj": energy_smooth,
        "n_items": n,
        "releases": releases,
        "configurations": configs,
        "idle_energy_mj": idle_mj,
        "lifetime_ms": lifetime,
    }


def _gaps_tensor(gaps, device) -> torch.Tensor:
    gaps = torch.as_tensor(gaps, dtype=_F64).to(device)
    if gaps.dim() != 2:
        raise ValueError(f"gaps must be (n_streams, n_gaps), got {tuple(gaps.shape)}")
    return gaps


@torch.no_grad()
def rollout(params, gaps, consts: dict, smooth: bool = False, jit: bool = True,
            device="cuda") -> dict:
    """Batched policy rollout on ``device`` (default the card).

    ``params`` — network parameter list (:func:`repro_torch.policy.net.
    init_mlp`, or numpy arrays of a :class:`~repro_torch.policy.train.
    TrainedPolicy`); a leading population axis on every leaf rolls out P
    networks at once; ``gaps`` — ``(n_streams, n_gaps)`` inter-arrival gaps
    (ms), e.g. from :meth:`repro_torch.core.arrivals.ArrivalProcess.
    sample_gaps`; ``consts`` — :func:`make_consts` output.  Returns
    per-stream float64 tensors on ``device`` — ``energy_mj``,
    ``energy_smooth_mj`` (== hard init energy unless ``smooth``),
    ``n_items``, ``releases``, ``configurations``, ``idle_energy_mj`` (the
    idle-waiting share of ``energy_mj`` — feed the output to
    :func:`repro_torch.obs.ledger.ledger_from_rollout` for the full phase
    breakdown), ``lifetime_ms`` — each ``(n_streams,)``, or ``(P,
    n_streams)`` for a population.  ``jit`` is kept for the reference's
    API and has no effect.
    """
    dev = resolve_device(device)
    gaps = _gaps_tensor(gaps, dev)
    population = torch.as_tensor(params[0]["w"]).dim() == 3
    out = _rollout_batch(N.to_tensors(params, dev), gaps, _const_tensors(consts, dev), smooth)
    return out if population else {k: v[0] for k, v in out.items()}


def mean_energy_per_gap(params, gaps: torch.Tensor, consts: dict, smooth: bool, feats=None):
    """Training objective: mean accumulated energy per gap, in units of one
    reconfiguration (dimensionless, O(1) across items) — differentiable in
    ``params`` on the smooth path, so both autograd (smooth) and ES
    perturbations (hard) run through it.  ``params`` are tensors on the
    gaps' device; ``consts`` floats or 0-d tensors; ``feats`` the gaps'
    :func:`feature_sequence`, when the caller keeps it across calls.
    Returns a 0-d tensor for one network, ``(P,)`` for a population."""
    c = _const_tensors(consts, gaps.device)
    out = _rollout_batch(params, gaps, c, smooth, feats)
    total = out["energy_smooth_mj"] if smooth else out["energy_mj"]
    per = torch.mean(total, dim=-1) / (gaps.shape[1] * c["e_config"])
    return per if params[0]["w"].dim() == 3 else per[0]
