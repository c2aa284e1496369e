"""Carry-dtype audit for the fleet tick loops (port of ``repro.fleet.dtypes``).

The hot loops (:func:`repro_torch.fleet.step.run_periodic` and the routed
tick of :func:`repro_torch.fleet.step.run_routed`) thread their state from
tick to tick.  Two silent failure modes live there:

* **promotion** — a carry leaf that comes back wider than it went in
  (e.g. an int32 counter promoted to int64 by a mixed-dtype ``where``)
  doubles the hot-loop memory traffic without changing any test result,
  and on a card it breaks the CUDA graph's static buffers;
* **wrap-around** — an int32 counter asked to count past 2^31 − 1 wraps
  silently.

This module pins the audited dtype contract:

* **counters** that can only grow by 1 per step (the periodic admitted-item
  counts) are **int32**, with an explicit
  :data:`~repro_torch.fleet.step.INT32_STEP_LIMIT` overflow guard at every
  entry point — a horizon past 2^31 steps raises ``OverflowError`` instead
  of wrapping;
* **energies and times stay float64 deliberately** — *not* fp32: the
  oracle bit-identity and 1e-9 ledger-conservation contracts are stated
  against the float64 scalar simulator, and the audit pins f64 explicitly
  so an accidental demotion fails just as loudly as a promotion;
* the routed :class:`~repro_torch.fleet.state.FleetState` keeps **int64**
  fleet-wide accumulators (``n_dropped`` absorbs global drop counts that
  can exceed 2^31 fleet-wide) — pinned, documented width, not an accident.

The reference reads carry dtypes through JAX's abstract evaluation; torch
has none, so the port runs one real step of the body (on a tiny fleet, the
audit costs nothing), the Monte Carlo ensemble's over a one-seed carry.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.fleet.state import FleetParams, FleetState

__all__ = [
    "PERIODIC_CARRY_DTYPES",
    "ENSEMBLE_CARRY_DTYPES",
    "ROUTED_CARRY_DTYPES",
    "scan_carry_dtypes",
    "audit_scan_body",
    "periodic_carry_dtypes",
    "ensemble_carry_dtypes",
    "routed_carry_dtypes",
]

#: Pinned carry dtypes of the periodic admission loop
#: (:func:`repro_torch.fleet.step._periodic_body`): ``(n, alive)``.
PERIODIC_CARRY_DTYPES = ("int32", "bool")

#: Pinned carry dtypes of the gap-driven ensemble loop
#: (:func:`repro_torch.mc.ensemble._periodic_ens_loop`):
#: ``(n, alive, cum_mj, lifetime_ms, idle_mj)``.
ENSEMBLE_CARRY_DTYPES = ("int32", "bool", "float64", "float64", "float64")

#: Pinned carry dtypes of the routed tick's :class:`FleetState`, in field
#: order.  The i64 counters are deliberate (see module docstring).
ROUTED_CARRY_DTYPES = {
    "energy_mj": "float64",
    "idle_energy_mj": "float64",
    "n_served": "int64",
    "n_configs": "int64",
    "n_released": "int64",
    "n_dropped": "int64",
    "resident": "bool",
    "alive": "bool",
    "completion_ms": "float64",
    "queue_ms": "float64",
    "q_head": "int32",
    "q_len": "int32",
    "rr_ptr": "int32",
}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaf_dtypes(tree, path: str = "") -> list[tuple[str, str]]:
    if isinstance(tree, torch.Tensor):
        return [(path, _dtype_name(tree))]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaf_dtypes(getattr(tree, f.name), f"{path}.{f.name}")]
    if isinstance(tree, (tuple, list)):
        return [leaf for i, t in enumerate(tree) for leaf in _leaf_dtypes(t, f"{path}[{i}]")]
    raise TypeError(f"carry leaf {path or '<root>'} is a {type(tree).__name__}, not a tensor")


def scan_carry_dtypes(body, carry, x=None) -> list[tuple[str, str, str]]:
    """Run one step of ``body`` and pair up carry dtypes.

    Returns ``[(leaf_path, dtype_in, dtype_out), ...]``.  The step runs for
    real, so audit a small carry.
    """
    out = body(carry, x)[0]
    din, dout = _leaf_dtypes(carry), _leaf_dtypes(out)
    if [p for p, _ in din] != [p for p, _ in dout]:
        raise TypeError(
            "scan body changed the carry structure: "
            f"{[p for p, _ in din]} -> {[p for p, _ in dout]}"
        )
    return [(p, a, b) for (p, a), (_, b) in zip(din, dout)]


def audit_scan_body(body, carry, x=None, name: str = "scan") -> list[str]:
    """Raise ``TypeError`` listing every carry leaf whose dtype changes
    across one step; returns the (empty) promotion list on success."""
    promoted = [
        f"{name}{path}: {a} -> {b}"
        for path, a, b in scan_carry_dtypes(body, carry, x)
        if a != b
    ]
    if promoted:
        raise TypeError(
            f"scan carry dtype drift in {name!r} (the tick loop would silently "
            f"widen its carry, and a CUDA graph's static buffers would not hold "
            f"it): " + "; ".join(promoted)
        )
    return promoted


# ---------------------------------------------------------------------------
# Audits of the real kernel bodies
# ---------------------------------------------------------------------------
def periodic_carry_dtypes(params: FleetParams) -> tuple[str, ...]:
    """Audited carry dtypes of the periodic admission loop (stable, else
    raises)."""
    from repro_torch.fleet.step import _periodic_body, _periodic_carry0, _periodic_limit

    carry = _periodic_carry0(params)
    audit_scan_body(_periodic_body(params, _periodic_limit(params)), carry, None, name="periodic")
    return tuple(_dtype_name(c) for c in carry)


def ensemble_carry_dtypes(params: FleetParams) -> tuple[str, ...]:
    """Audited carry dtypes of the gap-driven ensemble loop (stable, else
    raises)."""
    from repro_torch.mc.ensemble import _ens_body, _ens_carry0, _ens_limit

    carry = _ens_carry0(params)
    g = torch.zeros((1, params.n_devices), dtype=torch.float64, device=params.device)
    audit_scan_body(_ens_body(params, _ens_limit(params)), carry, (g, g), name="ensemble")
    return tuple(_dtype_name(c) for c in carry)


def routed_carry_dtypes(params: FleetParams, queue_capacity: int = 4) -> dict[str, str]:
    """Audited carry dtypes of the routed tick (direct arrivals)."""
    from repro_torch.fleet.step import _routed_body

    n = params.n_devices
    state0 = FleetState.init(n, queue_capacity, device=params.device)
    body = _routed_body(params, 1.0, None, False, queue_capacity)
    x = (
        torch.zeros((), dtype=torch.int64, device=params.device),
        torch.zeros((n,), dtype=torch.int32, device=params.device),
    )
    audit_scan_body(body, state0.leaves(), x, name="routed")
    return {f.name: _dtype_name(getattr(state0, f.name)) for f in dataclasses.fields(state0)}
