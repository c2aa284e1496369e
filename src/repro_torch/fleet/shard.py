"""Sharded fleet kernels: million-device scans over a mesh of ranks (port of
``repro.fleet.shard``).

:func:`run_periodic_sharded` partitions the device axis of
:func:`repro_torch.fleet.step.run_periodic` over a 2-D ``("fleet", "seed")``
mesh of the ranks :func:`repro_torch.distributed.ranks.spawn` started;
:func:`run_periodic_ensemble_sharded` does the same for the Monte Carlo
ensemble, sharding devices over the ``fleet`` axis and seeds over the
``seed`` axis.  Every rank of the spawn calls them with the same arguments
(the reference's ``shard_map`` program, written out SPMD): each takes its
own block, runs it on its device, and the ranks exchange what they must
through :mod:`repro_torch.distributed.ranks`' collectives.  A rank outside
the mesh (a mesh smaller than the spawn) returns ``None``.

The correctness contract is **bit-identity**, not approximation:

* every shard runs the *same* body the unsharded runners use
  (:func:`repro_torch.fleet.step._periodic_body`,
  :func:`repro_torch.mc.ensemble._ens_body`) — per-device trajectories are
  embarrassingly parallel, so partitioning cannot reassociate any float;
* the only cross-shard reduction is the per-step alive count — an **int32
  sum**, which is exact, so the per-shard partial sums summed over the mesh
  reproduce the unsharded sum bit for bit;
* fleets that don't divide the shard count are padded with *inert* devices
  (``feasible=False``, zero budget) that can never admit — they contribute
  exactly 0 to every total and are stripped before results are returned
  (:func:`pad_fleet`);
* a 1×1 mesh collapses to the single-device path, with no spawn.

The loop is chunked (``step_chunk`` steps a chunk, the carry left on the
rank's device between chunks, CUDA graphs on a card as in
:func:`~repro_torch.fleet.step.run_periodic`), and admission monotonicity
(once a device stops admitting it never resumes) lets the runner stop
early — with zeros filled in for the remaining steps, still bit-exact — the
moment a chunk ends with zero admissions fleet-wide.

The 1×1-mesh-equals-unsharded claim, as a doctest:

>>> import torch
>>> from repro_torch.fleet import run_periodic, uniform_fleet
>>> from repro_torch.fleet.shard import fleet_mesh, run_periodic_sharded
>>> params = uniform_fleet(3, strategies=("on_off", "idle_waiting"),
...                        e_budget_mj=100.0, device="cpu")
>>> a = run_periodic(params, 40)
>>> b = run_periodic_sharded(params, 40, mesh=fleet_mesh(1, 1))
>>> all(torch.equal(getattr(a, f), getattr(b, f)) for f in
...     ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time"))
True

Inside ``spawn(8, ...)`` the same call with ``fleet_mesh(2, 2)`` returns the
same bits — ``tests/test_torch_fleet_sharded.py`` sweeps mesh shapes
{1,2,4}×{1,2} against the unsharded runner and the JAX package's sharded
one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.fleet.state import FleetParams
from repro_torch.fleet.step import (
    PeriodicFleetResult,
    _check_step_count,
    _periodic_carry0,
    _periodic_final,
    _periodic_limit,
    _periodic_steps,
)

__all__ = [
    "FLEET_RULES",
    "MESH_AXES",
    "ShardedPeriodicResult",
    "fleet_mesh",
    "pad_fleet",
    "parse_mesh_spec",
    "run_periodic_sharded",
    "run_periodic_ensemble_sharded",
    "shard_slices",
    "sharded_periodic_ens_scan",
]

#: Physical mesh axes every fleet mesh carries, in order.
MESH_AXES = ("fleet", "seed")

#: Logical-axis rules (extends the shared DEFAULT_RULES table): the periodic
#: kernel shards its device axis over the *whole* mesh (no replication
#: anywhere); the ensemble splits devices over ``fleet`` and seeds over
#: ``seed``.
FLEET_RULES: shd.Rules = dict(
    shd.DEFAULT_RULES,
    fleet_device=MESH_AXES,
    ens_device="fleet",
    mc_seed="seed",
)


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------
def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """CLI mesh spec → ``(fleet, seed)`` axis sizes.

    ``"4"`` → (4, 1); ``"2x2"`` → (2, 2); ``"auto"`` → one rank a card on
    the fleet axis (1 on a host with no card).
    """
    s = str(spec).strip().lower()
    if s == "auto":
        return (max(1, torch.cuda.device_count()), 1)
    parts = s.split("x")
    try:
        if len(parts) == 1:
            return (int(parts[0]), 1)
        if len(parts) == 2:
            return (int(parts[0]), int(parts[1]))
    except ValueError:
        pass
    raise ValueError(
        f"bad mesh spec {spec!r}: expected 'F', 'FxS', or 'auto' (e.g. '4' or '2x2')"
    )


def fleet_mesh(fleet: Optional[int] = None, seed: int = 1) -> shd.Mesh:
    """A ``("fleet", "seed")`` mesh over the first ``fleet × seed`` ranks
    (default: every rank of the spawn on the fleet axis).  1×1 needs no
    spawn; a larger mesh must be built by every rank of one
    (:func:`repro_torch.distributed.ranks.make_mesh`)."""
    if seed < 1:
        raise ValueError(f"seed axis size must be >= 1, got {seed}")
    if fleet is None:
        fleet = max(1, ranks.world_size() // seed)
    if fleet < 1:
        raise ValueError(f"fleet axis size must be >= 1, got {fleet}")
    return ranks.make_mesh((fleet, seed), MESH_AXES)


def shard_slices(n_devices: int, n_shards: int) -> list[slice]:
    """Device-index slices each shard owns after :func:`pad_fleet` —
    contiguous blocks of the padded axis, clipped to the real fleet (the
    last shards may own only padding and get empty slices)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    per = (n_devices + (-n_devices) % n_shards) // n_shards
    return [
        slice(min(i * per, n_devices), min((i + 1) * per, n_devices))
        for i in range(n_shards)
    ]


# ---------------------------------------------------------------------------
# Pad-and-mask
# ---------------------------------------------------------------------------
#: Column values of an inert padding device: infeasible (never admits a
#: single request), zero budget, On-Off accounting (final energy
#: ``n · e_item`` is exactly 0 at n = 0) — it contributes 0 to every sum.
_PAD_COLUMNS = {
    "strategy": 0,
    "is_onoff": True,
    "feasible": False,
    "period_ms": 1.0,
    "e_budget_mj": 0.0,
    "e_item_mj": 0.0,
    "e_init_mj": 0.0,
    "e_idle_mj": 0.0,
    "e_exec_mj": 0.0,
    "t_exec_ms": 1.0,
    "e_config_mj": 0.0,
    "t_config_ms": 0.0,
    "p_idle_mw": 0.0,
    "timeout_ms": 0.0,
    "e_overhead_mj": 0.0,
}


def _block(t: torch.Tensor, dim: int, n_real: int, n_shards: int, i: int, fill=0) -> torch.Tensor:
    """Shard ``i``'s block of ``t`` along ``dim`` once the axis is padded to
    a multiple of ``n_shards`` with ``fill`` — the real part sliced, the
    padding made, the whole never built."""
    per = -(-n_real // n_shards)
    lo, hi = min(i * per, n_real), min((i + 1) * per, n_real)
    part = t.narrow(dim, lo, hi - lo)
    if hi - lo == per:
        return part
    shape = list(t.shape)
    shape[dim] = per - (hi - lo)
    return torch.cat([part, torch.full(shape, fill, dtype=t.dtype, device=t.device)], dim=dim)


def _params_block(params: FleetParams, n_shards: int, i: int, device) -> FleetParams:
    n = params.n_devices
    return FleetParams(**{
        f.name: _block(getattr(params, f.name), 0, n, n_shards, i, _PAD_COLUMNS[f.name]).to(device)
        for f in dataclasses.fields(params)
    })


def pad_fleet(params: FleetParams, multiple: int) -> tuple[FleetParams, int]:
    """Pad the device axis up to a multiple of ``multiple`` with inert
    devices; returns ``(padded_params, n_padding)``.

    Inert means *provably* zero-contribution: ``feasible=False`` blocks
    every admission, so the padded devices report ``n_items = 0``, energy
    0, and add 0 to each ``alive_over_time`` count — padding is masked out
    of the totals by construction, not by post-hoc subtraction.
    """
    if multiple < 1:
        raise ValueError(f"pad multiple must be >= 1, got {multiple}")
    pad = (-params.n_devices) % multiple
    if pad == 0:
        return params, 0
    return FleetParams(**{
        f.name: torch.cat([getattr(params, f.name),
                           torch.full((pad,), _PAD_COLUMNS[f.name],
                                      dtype=getattr(params, f.name).dtype, device=params.device)])
        for f in dataclasses.fields(params)
    }), pad


# ---------------------------------------------------------------------------
# Periodic kernel, sharded
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedPeriodicResult(PeriodicFleetResult):
    """A :class:`PeriodicFleetResult` (same tensors, on the rank's device,
    same ``ledger()`` / metrics integration, padding already stripped) plus
    the shard geometry, how far the chunked loop actually ran before the
    early exit (``steps_executed < n_steps`` means the whole fleet was dead
    and the remaining ``alive_over_time`` entries are exact zeros) and the
    runtime under the mesh (:func:`repro_torch.distributed.ranks.info`).
    """

    mesh_shape: tuple = (1, 1)
    n_shards: int = 1
    n_padding: int = 0
    steps_executed: int = 0
    runtime: Optional[dict] = None


def _mesh_shape(mesh: shd.Mesh) -> tuple:
    return tuple(int(mesh.shape[a]) for a in MESH_AXES)


def run_periodic_sharded(
    params: FleetParams,
    n_steps: int,
    mesh: Optional[shd.Mesh] = None,
    *,
    step_chunk: Optional[int] = None,
    jit: bool = True,
) -> Optional[ShardedPeriodicResult]:
    """:func:`repro_torch.fleet.step.run_periodic` with the device axis
    sharded over ``mesh`` — bit-identical results for any mesh shape.

    Every rank of the spawn calls it with the whole fleet (on any device);
    each runs its block on its own device and all of them return the whole
    result there (``None`` on a rank outside the mesh).  ``mesh`` defaults
    to every rank on the fleet axis (:func:`fleet_mesh`); a 1×1 mesh is the
    single-device path.  ``step_chunk`` bounds each chunk of the loop
    (default: the whole horizon up to 4096 steps) — chunk boundaries cannot
    perturb results (the carry is exact), they only set the early-exit
    granularity.
    """
    if n_steps < 0:
        raise ValueError(f"n_steps must be non-negative, got {n_steps}")
    _check_step_count(n_steps, "run_periodic_sharded")
    if mesh is None:
        mesh = fleet_mesh()
    with shd.use_sharding(mesh, FLEET_RULES):
        n_shards = shd.axis_size("fleet_device")
    if step_chunk is None:
        step_chunk = max(1, min(n_steps, 4096))
    if step_chunk < 1:
        raise ValueError(f"step_chunk must be >= 1, got {step_chunk}")
    if not mesh.is_member:
        return None

    device = mesh.device if mesh.device is not None else params.device
    n_real = params.n_devices
    local = _params_block(params, n_shards, mesh.index(MESH_AXES), device)
    limit = _periodic_limit(local)
    carry = _periodic_carry0(local)
    ts_parts: list[torch.Tensor] = []
    done = 0
    while done < n_steps:
        c = min(step_chunk, n_steps - done)
        carry, ts = _periodic_steps(local, limit, carry, c, jit)
        # int32 partial sums summed over the mesh == the unsharded sum, exactly
        ts_parts.append(ranks.psum(ts, MESH_AXES, mesh))
        done += c
        if done < n_steps and int(ts_parts[-1][-1]) == 0:
            # admission is monotone per device, so a step with zero
            # admissions fleet-wide freezes every carry: the remaining
            # alive_over_time entries are exact zeros
            ts_parts.append(torch.zeros(n_steps - done, dtype=torch.int32, device=device))
            break
    alive_ts = torch.cat(ts_parts) if ts_parts else torch.zeros(0, dtype=torch.int32, device=device)
    n, alive = (ranks.all_gather(c, MESH_AXES, 0, mesh)[:n_real] for c in carry)
    # final energies through the expression run_periodic uses, on the
    # original (unpadded) params
    full = params if params.device == device else FleetParams(
        **{f.name: getattr(params, f.name).to(device) for f in dataclasses.fields(params)})
    energy, lifetime = _periodic_final(full, n)
    return ShardedPeriodicResult(
        params=full,
        n_steps=n_steps,
        n_items=n.to(torch.int64),
        energy_mj=energy,
        lifetime_ms=lifetime,
        alive=alive,
        alive_over_time=alive_ts,
        mesh_shape=_mesh_shape(mesh),
        n_shards=n_shards,
        n_padding=(-n_real) % n_shards,
        steps_executed=done,
        runtime=ranks.info(),
    )


# ---------------------------------------------------------------------------
# Ensemble kernel, sharded
# ---------------------------------------------------------------------------
def sharded_periodic_ens_scan(params: FleetParams, gaps, mesh: shd.Mesh, jit: bool = True,
                              period_scale=None):
    """The sharded replacement for the unsharded loop inside
    :func:`repro_torch.mc.ensemble.periodic_ensemble`: ``gaps`` is the whole
    ``(S, T, N)`` draw (a view will do), ``period_scale`` an optional
    ``(N,)`` factor on every gap; returns the same ``(n, alive, cum, life,
    idle)`` tuple of ``(S, N)`` tensors, bit-identical — every host-side
    aggregation (Welford, ledger, CI) downstream is therefore shared, not
    reimplemented.  Only this rank's ``(S/seed, T, N/fleet)`` block of gaps
    is ever copied."""
    from repro_torch.mc.ensemble import _gaps_buffer, _periodic_ens_loop

    with shd.use_sharding(mesh, FLEET_RULES):
        n_dev_shards = shd.axis_size("ens_device")
        n_seed_shards = shd.axis_size("mc_seed")
    S, _, N = (int(d) for d in gaps.shape)
    device = mesh.device if mesh.device is not None else params.device
    i_dev, i_seed = mesh.index("fleet"), mesh.index("seed")
    local = _params_block(params, n_dev_shards, i_dev, device)
    # padded devices are infeasible (alive0 = feasible = False), so their
    # gap values — zeros here — are never consulted
    g = _block(_block(gaps, 0, S, n_seed_shards, i_seed), 2, N, n_dev_shards, i_dev)
    buf = _gaps_buffer(g.to(device=device, dtype=torch.float64))
    del g
    if period_scale is not None:
        buf.mul_(_block(torch.as_tensor(period_scale), 0, N, n_dev_shards, i_dev).to(device))
    carry = _periodic_ens_loop(local, buf, jit)
    del buf
    out = []
    for c in carry:
        c = ranks.all_gather(c, "fleet", 1, mesh)
        out.append(ranks.all_gather(c, "seed", 0, mesh)[:S, :N])
    return tuple(out)


def run_periodic_ensemble_sharded(
    params: FleetParams,
    process,
    n_steps: int,
    n_seeds: int,
    mesh: Optional[shd.Mesh] = None,
    **kwargs,
):
    """:func:`repro_torch.mc.ensemble.run_periodic_ensemble` over a mesh of
    ranks.

    A thin wrapper: gap sampling, seed chunking (:func:`~repro_torch.mc.
    ensemble.chunk_seed` determinism), Welford merging and the EnergyLedger
    conservation contract all run through the unsharded code path — only
    the inner loop is sharded — so sharded ensembles are bit-identical to
    unsharded ones for the same ``(seed, seed_chunk)`` on the same kind of
    device.  Every rank draws each chunk's whole stream on its device (the
    generator's sequence cannot be cut) and keeps only its block.
    """
    from repro_torch.mc.ensemble import run_periodic_ensemble

    if mesh is None:
        mesh = fleet_mesh()
    return run_periodic_ensemble(params, process, n_steps, n_seeds, mesh=mesh, **kwargs)
