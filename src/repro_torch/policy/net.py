"""The timeout policy network: a small tanh MLP over the online features
(port of ``repro.policy.net``).

6 features -> a couple of tanh hidden layers -> one linear output, read as
a *log-multiplier* of the ski-rental break-even timeout:

    timeout_ms = T*_be · exp(clip(raw, ±LOG_SPAN))

The final layer is zero-initialised, so an untrained network IS the
ski-rental hybrid (timeout exactly T*_be everywhere) — training starts from
the 2-competitive baseline and can only be pulled away from it by gradient
evidence.  A numpy twin of the forward pass serves the per-request hot path
without tensor dispatch.

Parameters are a list of ``{"w": (a, b), "b": (b,)}`` float64 tensors.  A
*population* of networks (evolution strategies evaluates one per
perturbation) carries a leading axis on every leaf, ``{"w": (P, a, b),
"b": (P, b)}``, and :func:`apply_mlp` then takes features of shape
``(P, N, a)``: one batched matmul per layer for the whole population.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.policy.features import N_FEATURES

#: Output clip (natural-log units): timeouts live in
#: T*_be · [e^-LOG_SPAN, e^+LOG_SPAN] ≈ [T*_be/3000, 3000·T*_be], wide
#: enough to express both statics after eval-time snapping.
LOG_SPAN = 8.0

_F64 = torch.float64


def init_mlp(generator: torch.Generator, hidden=(24, 24), in_dim: int = N_FEATURES,
             device=None) -> list:
    """Parameter list ``[{"w": (a,b), "b": (b,)}, ...]`` in float64, drawn
    from ``generator`` and placed on ``device`` (default the generator's).

    Hidden layers get 1/sqrt(fan_in) normal init; the output layer is
    all-zero so ``apply_mlp == 0`` at init (see module docstring).  The
    reference draws from ``jax.random``: same law, other numbers.
    """
    sizes = (in_dim, *hidden, 1)
    on = generator.device if device is None else torch.device(device)
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        if last:
            w = torch.zeros((a, b), dtype=_F64)
        else:
            w = torch.randn((a, b), generator=generator, dtype=_F64,
                            device=generator.device) / float(np.sqrt(float(a)))
        params.append({"w": w.to(on), "b": torch.zeros((b,), dtype=_F64, device=on)})
    return params


def apply_mlp(params, x):
    """Raw scalar output (log timeout multiplier) for features ``x``:
    ``(..., a) → (...)`` for one network, ``(P, N, a) → (P, N)`` for a
    population."""
    h = x
    for layer in params[:-1]:
        h = torch.tanh(torch.matmul(h, layer["w"]) + _bias(layer))
    out = torch.matmul(h, params[-1]["w"]) + _bias(params[-1])
    return torch.squeeze(out, dim=-1)


def _bias(layer) -> torch.Tensor:
    b = layer["b"]
    return b[:, None, :] if layer["w"].dim() == 3 else b


def timeout_from_raw(raw, t_be_ms):
    """Decode the network output into a timeout (ms)."""
    return t_be_ms * torch.exp(torch.clamp(raw, -LOG_SPAN, LOG_SPAN))


def timeout_ms(params, features, t_be_ms):
    """features -> timeout (ms); the composition the rollout loop runs."""
    return timeout_from_raw(apply_mlp(params, features), t_be_ms)


def to_tensors(params, device="cpu") -> list:
    """A numpy (or tensor) parameter list as float64 tensors on ``device``:
    always a copy, so training in place leaves the caller's arrays alone."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=device, dtype=_F64).clone()
        return torch.tensor(np.asarray(x, dtype=np.float64), device=device)

    return [{k: leaf(layer[k]) for k in ("w", "b")} for layer in params]


# ---- numpy twin (serving hot path) ------------------------------------------

def params_to_numpy(params) -> list:
    """Materialise the parameter list as float64 numpy arrays for the
    wrapper."""
    return [{k: torch.as_tensor(layer[k]).detach().cpu().numpy().astype(np.float64)
             for k in ("w", "b")}
            for layer in params]


def apply_mlp_np(np_params, x) -> float:
    """Numpy forward pass; matches :func:`apply_mlp` to float64 rounding."""
    h = np.asarray(x, dtype=np.float64)
    for layer in np_params[:-1]:
        h = np.tanh(h @ layer["w"] + layer["b"])
    out = h @ np_params[-1]["w"] + np_params[-1]["b"]
    return float(out[0])


def timeout_ms_np(np_params, features, t_be_ms: float) -> float:
    raw = apply_mlp_np(np_params, features)
    return t_be_ms * float(np.exp(np.clip(raw, -LOG_SPAN, LOG_SPAN)))
