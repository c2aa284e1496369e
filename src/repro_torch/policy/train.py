"""Two-phase training of the timeout policy (port of ``repro.policy.train``).

Phase 1 — **backprop through the smooth relaxation**: autograd of the
smooth rollout energy (:func:`repro_torch.policy.rollout.mean_energy_per_gap`
with ``smooth=True``), stepped by :func:`repro_torch.optim.adamw.adamw`, one
Python loop iteration per optimisation step (the reference runs one jitted
``lax.scan``).

Phase 2 — **antithetic evolution strategies on the hard objective**: the
smooth relaxation is biased near the release boundary, and the *routed*
discrete dynamics (admission, inline reconfig delay) are not differentiable
at all, so the finisher estimates

    ∇f(θ) ≈ 1/(P·σ) · Σ_i (f(θ + σ·ε_i) − f(θ − σ·ε_i))/2 · ε_i

with mirrored Gaussian perturbations: the whole population (θ ± σ·ε_i, 2P
networks) runs as one batched hard rollout, its networks stacked on a
leading axis (:mod:`repro_torch.policy.net`).

Both phases start from a zero-output network, i.e. from the ski-rental
hybrid itself: training can only improve on the 2-competitive baseline
(``history["baseline_hard"]`` pins the starting cost for the benchmark).

Randomness: the reference draws the initial network, the training gaps and
the ES noise from ``jax.random``, which torch cannot reproduce.  Here they
come from ``torch.Generator``\\ s seeded by ``settings.seed`` (the network
and the gaps on the host, so a run on the card starts from the CPU's
inputs; the noise from ``seed + 1``).  :func:`train_policy` takes
``init_params=``, ``gaps=`` and ``es_noise=`` to feed both packages the
same arrays.  The flat parameter vector ES perturbs is ordered as the
reference's ``ravel_pytree`` orders it: layer by layer, ``b`` before ``w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.arrivals import (
    ArrivalProcess,
    DeterministicArrivals,
    DiurnalArrivals,
    FlashCrowdArrivals,
    MMPPArrivals,
    PoissonArrivals,
)
from repro_torch.core.phases import WorkloadItem
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import adamw
from repro_torch.policy import net as N
from repro_torch.policy.rollout import feature_sequence, make_consts, mean_energy_per_gap

_F64 = torch.float64

# Plain AdamW on raw float64 parameters: no weight decay (the zero-init
# output layer IS the ski-rental prior — decay would drag the policy back
# to it), full-precision moments, norm clip for the occasional cliff the
# hard objective's admission boundary produces under ES noise.
_OPT = adamw(weight_decay=0.0, clip_norm=10.0, moment_dtype=_F64)

#: Leaf order of the reference's ``ravel_pytree`` over ``[{"w", "b"}, ...]``:
#: keys sorted within each layer.
_KEYS = ("b", "w")


def _flat_dict(params: list) -> dict:
    """The parameter list as an ordered dict (layer by layer, ``b`` before
    ``w``) of the same tensors, for AdamW."""
    return {f"{i}.{k}": layer[k] for i, layer in enumerate(params) for k in _KEYS}


def ravel(params: list) -> torch.Tensor:
    """Flat parameter vector in the reference's ``ravel_pytree`` order."""
    return torch.cat([t.reshape(-1) for t in _flat_dict(params).values()])


def unravel(flat: torch.Tensor, like: list) -> list:
    """Inverse of :func:`ravel`; ``flat`` may carry a leading population
    axis, which every leaf then carries too."""
    lead = flat.shape[:-1]
    out, i = [], 0
    for layer in like:
        new = {}
        for k in _KEYS:
            n = layer[k].numel()
            new[k] = flat[..., i:i + n].reshape(*lead, *layer[k].shape)
            i += n
        out.append({"w": new["w"], "b": new["b"]})
    return out


def _bp_run(params: list, gaps, consts, lr, steps: int, feats=None):
    """``steps`` AdamW steps on the smooth objective; ``params`` are
    updated in place.  Returns (params, per-step losses)."""
    if feats is None:
        feats = feature_sequence(gaps, consts["t_be"])
    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    flat = _flat_dict(params)
    state = _OPT.init(flat)
    losses = []
    for _ in range(steps):
        loss = mean_energy_per_gap(params, gaps, consts, True, feats)
        grads = torch.autograd.grad(loss, list(flat.values()))
        losses.append(loss.detach())
        _, state, _ = _OPT.update(dict(zip(flat, grads)), state, flat, lr)
    for layer in params:
        for t in layer.values():
            t.requires_grad_(False)
    return params, torch.stack(losses) if losses else torch.zeros(0, dtype=_F64)


@torch.no_grad()
def _es_run(params: list, gaps, consts, lr, sigma: float, steps: int, half_pop: int,
            generator: torch.Generator | None = None, noise=None, feats=None):
    """``steps`` antithetic-ES steps on the hard objective; ``params`` are
    updated in place.  The noise of step t is ``noise[t]`` (shape
    ``(half_pop, d)``) when given, else drawn from ``generator``.  Returns
    (params, per-step mean population losses)."""
    if feats is None:
        feats = feature_sequence(gaps, consts["t_be"])
    flat = _flat_dict(params)
    state = _OPT.init(flat)
    d = sum(t.numel() for t in flat.values())
    dev = gaps.device
    # a tensor divisor: a CUDA tensor divided by a host scalar is a product
    # with its reciprocal
    two_sigma = torch.full((), 2.0 * sigma, dtype=_F64, device=dev)
    losses = []
    for t in range(steps):
        if noise is not None:
            eps = torch.as_tensor(noise[t], dtype=_F64).to(dev)
        else:
            eps = torch.randn((half_pop, d), generator=generator, dtype=_F64,
                              device=generator.device).to(dev)
        theta = ravel(params)
        pop = torch.cat([theta + sigma * eps, theta - sigma * eps])
        f = mean_energy_per_gap(unravel(pop, params), gaps, consts, False, feats)
        f_plus, f_minus = f[:half_pop], f[half_pop:]
        gflat = torch.mean((f_plus - f_minus)[:, None] * eps, dim=0) / two_sigma
        grads = _flat_dict(unravel(gflat, params))
        _, state, _ = _OPT.update(grads, state, flat, lr)
        losses.append(0.5 * (torch.mean(f_plus) + torch.mean(f_minus)))
    return params, torch.stack(losses) if losses else torch.zeros(0, dtype=_F64)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Knobs of one training run (defaults sized for CPU minutes)."""

    hidden: tuple = (24, 24)
    n_streams: int = 24          # training streams (mixture, round-robin)
    n_gaps: int = 384            # gaps per stream
    bp_steps: int = 300          # phase-1 optimisation steps
    bp_lr: float = 0.02
    es_steps: int = 120          # phase-2 optimisation steps
    es_lr: float = 0.01
    es_pop: int = 16             # perturbation pairs = es_pop // 2
    es_sigma: float = 0.05
    seed: int = 0

    @staticmethod
    def smoke() -> "TrainSettings":
        """CI-sized run: seconds on CPU, still clearly beats the hybrid."""
        return TrainSettings(
            hidden=(16, 16), n_streams=16, n_gaps=256,
            bp_steps=150, es_steps=40, es_pop=8,
        )


def training_processes(t_be_ms: float) -> list:
    """The regime mixture the policy trains on, scaled by the item's T*_be.

    Covers both statics' home turf (deterministic / Poisson well below and
    above the crossover — where the trained policy must not regress) and
    the three regime-switching shapes where the hybrid is beatable.
    """
    t = t_be_ms
    return [
        DeterministicArrivals(0.08 * t),
        DeterministicArrivals(0.6 * t),
        DeterministicArrivals(3.0 * t),
        PoissonArrivals(0.25 * t),
        PoissonArrivals(6.0 * t),
        MMPPArrivals(
            burst_ms=0.04 * t, quiet_ms=8.0 * t,
            mean_burst_len=12.0, mean_quiet_len=3.0,
        ),
        FlashCrowdArrivals(
            quiet_ms=6.0 * t, flash_gap_ms=0.02 * t,
            flash_len=32, flash_every=4.0,
        ),
        DiurnalArrivals(
            mean_ms=2.0 * t, day_ms=400.0 * t, amplitude=0.75,
            burst_ms=0.04 * t, mean_burst_len=10.0, mean_quiet_len=6.0,
        ),
    ]


def sample_training_gaps(
    processes: Sequence[ArrivalProcess],
    n_streams: int,
    n_gaps: int,
    seed: int,
    device="cuda",
) -> torch.Tensor:
    """``(n_streams, n_gaps)`` float64 gaps on ``device``, processes
    round-robined across rows so every training step sees the full mixture.
    The draws come from one host ``torch.Generator`` seeded with ``seed``,
    one process after another."""
    dev = resolve_device(device)
    g = torch.Generator("cpu").manual_seed(seed)
    per = int(math.ceil(n_streams / len(processes)))
    blocks = [p.sample_gaps(g, per, n_gaps) for p in processes]
    # interleave: row i is process (i mod P), stream (i div P)
    stacked = torch.stack(blocks, dim=1).reshape(-1, n_gaps)
    return stacked[:n_streams].to(dev)


@dataclasses.dataclass
class TrainedPolicy:
    """A trained timeout policy: parameters + the physics it was trained for.

    ``params`` is float64 numpy (JSON-serialisable via :meth:`to_json_dict`,
    in the reference's format, so a policy trained by either package loads
    in the other); ``consts`` the :func:`repro_torch.policy.rollout.
    make_consts` dict (with the training budget, normally ``inf``);
    ``history`` the loss curves and the ski-rental baseline cost; ``meta``
    the settings/method provenance.
    """

    params: list
    consts: dict
    history: dict
    meta: dict

    @property
    def t_be_ms(self) -> float:
        return float(self.consts["t_be"])

    def to_json_dict(self) -> dict:
        return {
            "params": [
                {"w": layer["w"].tolist(), "b": layer["b"].tolist()}
                for layer in self.params
            ],
            "consts": {
                k: (None if math.isinf(v) else float(v))
                for k, v in self.consts.items()
            },
            "history": {
                k: (list(map(float, v)) if isinstance(v, (list, np.ndarray)) else float(v))
                for k, v in self.history.items()
            },
            "meta": self.meta,
        }

    @staticmethod
    def from_json_dict(d: dict) -> "TrainedPolicy":
        params = [
            {"w": np.asarray(layer["w"], dtype=np.float64),
             "b": np.asarray(layer["b"], dtype=np.float64)}
            for layer in d["params"]
        ]
        consts = {
            k: (math.inf if v is None else float(v))
            for k, v in d["consts"].items()
        }
        return TrainedPolicy(
            params=params, consts=consts,
            history=dict(d.get("history", {})), meta=dict(d.get("meta", {})),
        )


def untrained_policy(
    item: WorkloadItem,
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    powerup_overhead_mj: float = 0.0,
    hidden: tuple = (8,),
) -> TrainedPolicy:
    """The zero-output network: exactly the ski-rental hybrid (timeout
    T*_be for every feature vector).  No training, no RNG — the documented
    stationary-limit anchor and the cheapest drop-in for tests."""
    consts = make_consts(item, method, powerup_overhead_mj)
    sizes = (N.N_FEATURES, *hidden, 1)
    params = [
        {"w": np.zeros((a, b), dtype=np.float64), "b": np.zeros((b,), dtype=np.float64)}
        for a, b in zip(sizes[:-1], sizes[1:])
    ]
    return TrainedPolicy(
        params=params,
        consts=consts,
        history={"baseline_hard": float("nan"), "final_hard": float("nan")},
        meta={
            "trained": False, "hidden": list(hidden),
            "method": method.name, "powerup_overhead_mj": powerup_overhead_mj,
        },
    )


def train_policy(
    item: WorkloadItem,
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    powerup_overhead_mj: float = 0.0,
    settings: Optional[TrainSettings] = None,
    processes: Optional[Sequence[ArrivalProcess]] = None,
    device="cuda",
    init_params: Optional[list] = None,
    gaps=None,
    es_noise=None,
) -> TrainedPolicy:
    """Run both phases on ``device`` (default the card) and return the
    trained policy.

    Deterministic in ``settings.seed``; ``processes`` overrides the default
    :func:`training_processes` mixture (e.g. to specialise on a tenant's
    recorded traces).  ``init_params`` (a parameter list), ``gaps``
    (``(n_streams, n_gaps)``) and ``es_noise`` (``(es_steps, es_pop // 2,
    d)``) replace the random draws, so two runs — or two packages — can be
    fed the same arrays.
    """
    st = settings or TrainSettings()
    dev = resolve_device(device)
    consts = make_consts(item, method, powerup_overhead_mj)
    procs = list(processes) if processes is not None else training_processes(consts["t_be"])

    if gaps is None:
        gaps = sample_training_gaps(procs, st.n_streams, st.n_gaps, st.seed, dev)
    gaps = torch.as_tensor(gaps, dtype=_F64).to(dev)
    if init_params is None:
        init_params = N.init_mlp(torch.Generator("cpu").manual_seed(st.seed), hidden=st.hidden)
    params = N.to_tensors(init_params, dev)

    feats = feature_sequence(gaps, consts["t_be"])      # the gaps' features, once
    with torch.no_grad():
        baseline_hard = float(mean_energy_per_gap(params, gaps, consts, False, feats))
    bp_losses = torch.zeros(0, dtype=_F64)
    if st.bp_steps > 0:
        lr = torch.full((), st.bp_lr, dtype=_F64, device=dev)
        params, bp_losses = _bp_run(params, gaps, consts, lr, st.bp_steps, feats)
    es_losses = torch.zeros(0, dtype=_F64)
    if st.es_steps > 0:
        lr = torch.full((), st.es_lr, dtype=_F64, device=dev)
        params, es_losses = _es_run(
            params, gaps, consts, lr, st.es_sigma, st.es_steps, max(st.es_pop // 2, 1),
            generator=torch.Generator("cpu").manual_seed(st.seed + 1), noise=es_noise, feats=feats,
        )
    with torch.no_grad():
        final_hard = float(mean_energy_per_gap(params, gaps, consts, False, feats))

    return TrainedPolicy(
        params=N.params_to_numpy(params),
        consts=consts,
        history={
            "bp_loss": bp_losses.cpu().numpy().astype(np.float64),
            "es_loss": es_losses.cpu().numpy().astype(np.float64),
            "baseline_hard": baseline_hard,
            "final_hard": final_hard,
        },
        meta={
            "trained": True,
            "hidden": list(st.hidden),
            "method": method.name,
            "powerup_overhead_mj": powerup_overhead_mj,
            "n_streams": st.n_streams, "n_gaps": st.n_gaps,
            "bp_steps": st.bp_steps, "es_steps": st.es_steps,
            "es_pop": st.es_pop, "es_sigma": st.es_sigma,
            "seed": st.seed,
            "processes": [p.name for p in procs],
        },
    )
