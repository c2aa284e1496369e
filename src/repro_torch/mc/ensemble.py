"""Seed-replicated stochastic fleet replications with streaming moments
(port of ``repro.mc.ensemble``).

Every headline number in this repo — 499.06 ms crossover, 12.39× lifetime,
energy-per-request, p99 latency — is a *point estimate* under perfectly
periodic requests.  This module turns each of them into a distribution: it
replicates a whole fleet across S independent random seeds and runs all
S × N trajectories through **one** tick loop whose carry has a leading seed
axis, ``(S, N)`` — no Python loop over seeds — reusing the fleet substrate
(:class:`repro_torch.fleet.state.FleetParams`, the routed tick body and the
tick loop of :mod:`repro_torch.fleet.step`, CUDA graphs on a card) and the
batched samplers of :mod:`repro_torch.core.arrivals`.  The reference runs
the same body under ``jax.vmap`` of a ``lax.scan``.

Two replication kernels:

* :func:`run_periodic_ensemble` — the paper's duty-cycle mode under
  stochastic inter-arrival gaps.  One loop step = one request per device
  per seed; request *k* is charged its execution energy plus the idle
  energy of the *realized* preceding gap (Idle-Waiting) or its full
  reconfigure-and-run energy (On-Off), admitted while the accumulated
  energy fits the budget — the gap-driven generalization of
  :func:`repro_torch.fleet.step.run_periodic`.  With zero-jitter gaps
  (e.g. :class:`~repro_torch.core.arrivals.JitteredArrivals` at
  ``jitter=0``) every seed collapses onto the deterministic closed forms:
  same admitted counts as the scalar oracle, same Eq.-4 lifetime.
* :func:`routed_ensemble` / :func:`run_routed_ensemble` — the routed
  tick-clock kernel (queues, exact latency timestamps) over ``(S, N)``,
  with the *identical* tick body ``run_routed`` uses, on per-device
  streams: each seed stays its own fleet (no router mixes seeds), for CI
  bands on p50/p99 latency.

Randomness: each seed chunk draws from its own ``torch.Generator`` on the
fleet's device, seeded by :func:`chunk_seed` from ``(seed, chunk index)`` —
numpy's ``SeedSequence`` mixes the pair into one 64-bit seed, the port's
stand-in for the reference's ``jax.random.fold_in(key, chunk_index)``.
The streams differ from the reference's, their law does not; fed the same
pre-sampled gaps or counts (:func:`periodic_ensemble`,
:func:`routed_ensemble`), the two packages agree.

Arithmetic: the idle energy of a realized gap is ``P · t · (1/1000)``, the
product the reference's compiled loop computes (XLA turns the constant
divisor ``/ 1000.0`` into a product with its reciprocal, as in the routed
tick, ROADMAP C-ref-7).  XLA on the CPU also fuses that product into the
two sums that take it (``cum + cost``, ``idle + idle_e``) as one fused
multiply-add; the port rounds every op, so its energies lie within an ulp
or two of the reference's (2.1e-16 relative on the parity tests' draws,
held to 1e-9: ROADMAP C-ref-8) while the admitted counts are equal.  Every
op is elementwise over the ``(S, N)`` carry, so the card, the CPU and the
eager and graph loops agree bit for bit.

Memory: per-seed *fleet aggregates* are O(S) scalars and always kept (the
bootstrap needs them); per-device moments across seeds are accumulated by
:class:`Welford` (Chan's parallel merge) over seed *chunks*, so S = 10k
replications of an N-device fleet run in memory constant in S — set
``seed_chunk`` to bound the live (chunk × steps × N) gap buffer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import ArrivalProcess, bin_arrival_counts
from repro_torch.fleet.state import FleetParams, FleetState
from repro_torch.fleet.step import _INV_1000, _check_step_count, _np, _routed_body, _run_loop

__all__ = [
    "Welford",
    "PeriodicEnsembleResult",
    "RoutedEnsembleResult",
    "chunk_seed",
    "periodic_ensemble",
    "run_periodic_ensemble",
    "routed_ensemble",
    "run_routed_ensemble",
]


# ---------------------------------------------------------------------------
# Streaming moments
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Welford:
    """Streaming mean/variance over an ensemble axis (Welford / Chan merge).

    ``update`` consumes one *batch* of replications at a time (shape
    ``(chunk, ...)``), merging the batch's moments into the running state
    with Chan's parallel-update formula — numerically stable and O(element)
    memory, so 10k-seed ensembles never materialize a (S, N) array.

    >>> import numpy as np
    >>> w = Welford()
    >>> x = np.arange(12.0).reshape(4, 3)
    >>> _ = w.update(x[:2]); _ = w.update(x[2:])
    >>> bool(np.allclose(w.mean, x.mean(axis=0)))
    True
    >>> bool(np.allclose(w.variance, x.var(axis=0, ddof=1)))
    True
    """

    count: int = 0
    mean: Optional[np.ndarray] = None
    m2: Optional[np.ndarray] = None

    def update(self, batch) -> "Welford":
        b = np.asarray(batch, dtype=np.float64)
        if b.ndim == 0:
            b = b.reshape(1)
        nb = b.shape[0]
        if nb == 0:
            return self
        bm = b.mean(axis=0)
        bm2 = ((b - bm) ** 2).sum(axis=0)
        if self.count == 0:
            self.count, self.mean, self.m2 = nb, bm, bm2
            return self
        n = self.count + nb
        delta = bm - self.mean
        self.mean = self.mean + delta * (nb / n)
        self.m2 = self.m2 + bm2 + delta * delta * (self.count * nb / n)
        self.count = n
        return self

    @property
    def variance(self) -> np.ndarray:
        """Unbiased (ddof=1) variance; 0 until two replications are seen."""
        if self.count < 2:
            return np.zeros_like(np.asarray(self.mean, dtype=np.float64))
        return self.m2 / (self.count - 1)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)

    @property
    def sem(self) -> np.ndarray:
        """Standard error of the mean over the ensemble axis."""
        if self.count < 1:
            raise ValueError("Welford has seen no replications")
        return self.std / math.sqrt(self.count)


def _merge_welford(a: Welford, b: Welford) -> Welford:
    """Chan's pairwise merge of two streaming-moment states."""
    if a.count == 0:
        return b
    if b.count == 0:
        return a
    n = a.count + b.count
    delta = b.mean - a.mean
    return Welford(
        count=n,
        mean=a.mean + delta * (b.count / n),
        m2=a.m2 + b.m2 + delta * delta * (a.count * b.count / n),
    )


def chunk_seed(seed: int, chunk_index: int) -> int:
    """The 64-bit ``torch.Generator`` seed of one seed chunk: ``(seed,
    chunk_index)`` mixed by numpy's ``SeedSequence`` — the port's
    ``jax.random.fold_in(PRNGKey(seed), chunk_index)``."""
    return int(np.random.SeedSequence([int(seed), int(chunk_index)]).generate_state(1, np.uint64)[0])


# ---------------------------------------------------------------------------
# Periodic (gap-driven) ensemble
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PeriodicEnsembleResult:
    """S fleet replications of the duty-cycle mode under stochastic gaps.

    Per-seed fleet aggregates are 1-D ``(S,)`` numpy arrays (bootstrap
    inputs); per-device cross-seed moments live in the :class:`Welford`
    fields.  The ``(S, N)`` per-device samples are kept only when the run
    was launched with ``keep_device_samples=True``.
    """

    params: FleetParams
    process: str
    n_seeds: int
    n_steps: int
    # per-seed fleet aggregates, shape (S,)
    lifetime_ms: np.ndarray            # device-mean Eq.-4 lifetime
    total_items: np.ndarray            # requests admitted fleet-wide
    total_energy_mj: np.ndarray
    energy_per_request_mj: np.ndarray
    # per-device moments across seeds (arrays of shape (N,))
    device_lifetime_ms: Welford
    device_energy_mj: Welford
    device_items: Welford
    # per-seed fleet-aggregate phase ledger (each axis shape (S,)); axes sum
    # to total_energy_mj within 1e-9 relative (the conservation contract)
    ledger: Optional[object] = None
    # optional full per-device samples, shape (S, N)
    per_device_items: Optional[np.ndarray] = None
    per_device_energy_mj: Optional[np.ndarray] = None
    per_device_lifetime_ms: Optional[np.ndarray] = None

    @property
    def n_devices(self) -> int:
        return self.params.n_devices


def _ens_body(params: FleetParams, limit):
    """The one gap-driven admission step over an ``(S, N)`` carry.  Carry:
    ``(n int32, alive bool, cum f64, life f64, idle f64)`` — the audited
    dtype contract of :mod:`repro_torch.fleet.dtypes`; input: the gaps
    before and after this request, ``(S, N)`` each; no output."""

    def body(carry, g):
        gp, gn = g
        n, alive, cum, life, idle_acc = carry
        idle_t = torch.clamp_min(gp - params.t_exec_ms, 0.0)
        idle_e = params.p_idle_mw * idle_t * _INV_1000
        cost = torch.where(params.is_onoff, params.e_item_mj, params.e_item_mj + idle_e)
        admit = alive & (cum + cost <= limit)
        cum = torch.where(admit, cum + cost, cum)
        # the idle-waiting share of the same accumulation (ledger axis)
        idle_acc = torch.where(admit & ~params.is_onoff, idle_acc + idle_e, idle_acc)
        n = n + admit.to(torch.int32)
        life = torch.where(admit, life + gn, life)
        return (n, admit, cum, life, idle_acc), ()

    return body


def _ens_carry0(params: FleetParams, n_seeds: int = 1):
    shape = (n_seeds, params.n_devices)
    dev = params.device
    return (
        torch.zeros(shape, dtype=torch.int32, device=dev),
        # an infeasible device (period below the strategy's latency) never
        # admits — the same static gate run_periodic applies every step
        params.feasible.expand(shape).clone(),
        # Idle-Waiting owes its one-time bring-up before the first item
        torch.where(params.is_onoff, 0.0, params.e_init_mj).expand(shape).clone(),
        torch.zeros(shape, dtype=torch.float64, device=dev),
        torch.zeros(shape, dtype=torch.float64, device=dev),
    )


def _ens_limit(params: FleetParams):
    # the same admission slack run_periodic grants (FLOOR_EPS of one
    # nominal period), so the deterministic limit shares its boundary rule
    return params.e_budget_mj + em.FLOOR_EPS * (params.e_item_mj + params.e_idle_mj)


def _periodic_ens_loop(params: FleetParams, gaps_t: torch.Tensor, jit: bool):
    """All S × N trajectories through the gap-driven admission loop.

    ``gaps_t`` is ``(n_steps + 1, S, N)`` float64: row 0 zeros, row k + 1
    the realized gap *following* request k + 1.  Step k reads row k (the gap
    *preceding* request k + 1 — 0 for the first request, which arrives at
    t = 0: ``max(0 − t_exec, 0)`` charges it no idle, and the E_init it owes
    is pre-loaded into the energy carry) and row k + 1 (the period the
    request occupies, so Eq. 4's ``lifetime = Σ gaps of admitted requests``
    reduces to ``n · T_req`` exactly in the deterministic limit).

    Returned energies include the pre-loaded E_init even for devices that
    admitted nothing; :func:`periodic_ensemble` zeroes those (the oracle's
    ``n = 0 → energy 0`` convention).
    """
    n_steps, n_seeds = int(gaps_t.shape[0]) - 1, int(gaps_t.shape[1])
    carry, _ = _run_loop(_ens_body(params, _ens_limit(params)), _ens_carry0(params, n_seeds),
                         (gaps_t[:-1], gaps_t[1:]), n_steps, jit)
    return carry


def _gaps_buffer(gaps: torch.Tensor) -> torch.Tensor:
    """``(S, T, N)`` gaps → the loop's ``(T + 1, S, N)`` buffer (row 0 zeros)."""
    s, t, n = gaps.shape
    buf = torch.empty((t + 1, s, n), dtype=torch.float64, device=gaps.device)
    buf[0].zero_()
    buf[1:].copy_(gaps.permute(1, 0, 2))
    return buf


def periodic_ensemble(
    params: FleetParams,
    gaps,
    jit: bool = True,
    keep_device_samples: bool = False,
    mesh=None,
) -> PeriodicEnsembleResult:
    """Run S duty-cycle replications from pre-sampled inter-arrival gaps.

    ``gaps`` is ``(S, n_steps, N)`` float — ``gaps[s, k, d]`` is the gap
    *following* request k+1 on device d in replication s (e.g. from
    :meth:`~repro_torch.core.arrivals.ArrivalProcess.sample_gaps`,
    reshaped); a tensor or an array, moved to the fleet's device.  All
    S × N trajectories advance through one tick loop over an ``(S, N)``
    carry (CUDA graphs on a card when ``jit``); this is the timed engine of
    the ``launch.mc`` throughput row (stream sampling excluded on both
    sides, the same convention ``launch.fleet`` uses for its looped
    baseline).

    With ``mesh`` (a ``("fleet", "seed")`` mesh from
    :func:`repro_torch.fleet.shard.fleet_mesh`, called by every rank of a
    spawn) the seed and device axes are partitioned over the ranks — every
    trajectory still runs the identical body, so results are bit-identical
    to the unsharded path; all host-side aggregation below is shared
    verbatim.  A rank outside the mesh returns ``None``.
    """
    _check_mesh(mesh)
    gaps = torch.as_tensor(gaps)
    if gaps.ndim != 3 or gaps.shape[2] != params.n_devices:
        raise ValueError(
            f"gaps must be (n_seeds, n_steps, {params.n_devices}), got shape {tuple(gaps.shape)}"
        )
    n_seeds, n_steps = int(gaps.shape[0]), int(gaps.shape[1])
    _check_step_count(n_steps, "periodic_ensemble")
    if mesh is not None:
        if not mesh.is_member:
            return None
        from repro_torch.fleet.shard import sharded_periodic_ens_scan

        carry = sharded_periodic_ens_scan(params, gaps, mesh, jit)
    else:
        gaps = gaps.to(device=params.device, dtype=torch.float64)
        carry = _periodic_ens_loop(params, _gaps_buffer(gaps), jit)
    return _periodic_result(params, carry, n_steps, keep_device_samples)


def _check_mesh(mesh) -> None:
    from repro_torch.distributed.sharding import Mesh

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh (fleet.shard.fleet_mesh), got {type(mesh).__name__}")


def _periodic_result(params, carry, n_steps, keep_device_samples) -> PeriodicEnsembleResult:
    n, _, cum, life, idle_acc = (_np(c) for c in carry)
    # the loop pre-loads E_init into the energy carry; a device that admitted
    # nothing spent nothing (the oracle's n = 0 convention)
    cum = np.where(n > 0, cum, 0.0)
    total_items = n.sum(axis=1)
    total_energy = cum.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        epr = np.where(total_items > 0, total_energy / np.maximum(total_items, 1), np.nan)
    return PeriodicEnsembleResult(
        params=params,
        process="direct",
        n_seeds=int(n.shape[0]),
        n_steps=n_steps,
        lifetime_ms=life.mean(axis=1),
        total_items=total_items,
        total_energy_mj=total_energy,
        energy_per_request_mj=epr,
        device_lifetime_ms=Welford().update(life),
        device_energy_mj=Welford().update(cum),
        device_items=Welford().update(n.astype(np.float64)),
        ledger=_periodic_ledger(params, n, idle_acc),
        per_device_items=n if keep_device_samples else None,
        per_device_energy_mj=cum if keep_device_samples else None,
        per_device_lifetime_ms=life if keep_device_samples else None,
    )


def _periodic_ledger(params: FleetParams, n: np.ndarray, idle: np.ndarray):
    """Per-seed fleet-aggregate :class:`repro_torch.obs.ledger.EnergyLedger`
    (each axis ``(S,)``) from the ``(S, N)`` admitted counts and the loop's
    idle-energy accumulator, through the same per-item constants the
    admission costs used."""
    from repro_torch.obs.ledger import EnergyLedger

    is_onoff = _np(params.is_onoff)
    ovh = _np(params.e_overhead_mj)
    cfg_pure = _np(params.e_config_mj) - ovh
    e_exec = _np(params.e_exec_mj)
    nf = n.astype(np.float64)                          # (S, N)
    # On-Off pays configure+overhead per item; Idle-Waiting once (E_init)
    n_cfg = np.where(is_onoff, nf, (n > 0).astype(np.float64))
    return EnergyLedger.from_axes(
        configure=(n_cfg * cfg_pure).sum(axis=1),
        compute=(nf * e_exec).sum(axis=1),
        idle=idle.sum(axis=1),
        off=np.zeros(n.shape[0], dtype=np.float64),
        overhead=(n_cfg * ovh).sum(axis=1),
    )


def _merge_ledgers(ledgers):
    """Concatenate per-seed ledgers along the seed axis (None passes through)."""
    from repro_torch.obs.ledger import AXES, EnergyLedger

    if any(led is None for led in ledgers):
        return None
    return EnergyLedger(
        **{
            f"{a}_mj": np.concatenate(
                [np.atleast_1d(np.asarray(getattr(led, f"{a}_mj"))) for led in ledgers]
            )
            for a in AXES
        }
    )


def _merge_periodic(parts: list[PeriodicEnsembleResult]) -> PeriodicEnsembleResult:
    first = parts[0]
    if len(parts) == 1:
        return first
    w_life, w_energy, w_items = (
        first.device_lifetime_ms, first.device_energy_mj, first.device_items
    )
    for p in parts[1:]:
        w_life = _merge_welford(w_life, p.device_lifetime_ms)
        w_energy = _merge_welford(w_energy, p.device_energy_mj)
        w_items = _merge_welford(w_items, p.device_items)
    cat = np.concatenate
    keep = first.per_device_items is not None
    return dataclasses.replace(
        first,
        n_seeds=sum(p.n_seeds for p in parts),
        lifetime_ms=cat([p.lifetime_ms for p in parts]),
        total_items=cat([p.total_items for p in parts]),
        total_energy_mj=cat([p.total_energy_mj for p in parts]),
        energy_per_request_mj=cat([p.energy_per_request_mj for p in parts]),
        device_lifetime_ms=w_life,
        device_energy_mj=w_energy,
        device_items=w_items,
        ledger=_merge_ledgers([p.ledger for p in parts]),
        per_device_items=cat([p.per_device_items for p in parts]) if keep else None,
        per_device_energy_mj=cat([p.per_device_energy_mj for p in parts]) if keep else None,
        per_device_lifetime_ms=cat([p.per_device_lifetime_ms for p in parts]) if keep else None,
    )


def run_periodic_ensemble(
    params: FleetParams,
    process: ArrivalProcess,
    n_steps: int,
    n_seeds: int,
    seed: int = 0,
    seed_chunk: Optional[int] = None,
    keep_device_samples: bool = False,
    jit: bool = True,
    scale_to_device_periods: bool = False,
    mesh=None,
) -> PeriodicEnsembleResult:
    """Replicate an N-device duty-cycle fleet over ``n_seeds`` independent
    request streams drawn from ``process``, on the fleet's device.

    Heterogeneous fleets: with ``scale_to_device_periods=True`` every
    device's sampled gaps are rescaled by ``params.period_ms[d] /
    process.mean_period_ms()``, so a fleet mixing models with different
    request periods (e.g. :func:`repro_torch.costs.model_mix_fleet`) sees
    each device's own traffic rate while sharing the process's *shape*
    (burstiness, jitter).  The zero-variance limit is preserved: a
    deterministic process rescales to exactly each device's period, so the
    ensemble still collapses onto :func:`repro_torch.fleet.step.run_periodic`.

    Each chunk of seeds samples its gaps in one batched call
    (:meth:`~repro_torch.core.arrivals.ArrivalProcess.sample_gaps`, from the
    chunk's generator, :func:`chunk_seed`) and advances all chunk × N
    trajectories through :func:`periodic_ensemble`'s loop; chunk results
    merge via Chan's parallel Welford update, so memory is bounded by the
    ``seed_chunk × n_steps × N`` gap buffer regardless of ``n_seeds``.

    Deterministic limit: with a zero-variance process every seed's admitted
    counts equal :func:`repro_torch.fleet.step.run_periodic`'s (and hence
    the scalar Eq.-3 oracle's) and every CI degenerates to the point
    estimate.

    Reproducibility: results are a deterministic function of ``(seed,
    seed_chunk)`` on one device — changing the chunk size repartitions the
    randomness (it never changes the *distribution*).

    ``mesh`` (from :func:`repro_torch.fleet.shard.fleet_mesh`, every rank
    of a spawn calling with the same arguments) shards every chunk's seed
    and device axes over the ranks; gap sampling, chunking and all
    host-side merging are identical, so sharded results are bit-identical
    to the unsharded run for the same ``(seed, seed_chunk)`` on the same
    kind of device.  Each rank draws the chunk's whole stream and keeps its
    block.  A rank outside the mesh returns ``None``.
    """
    _check_mesh(mesh)
    if mesh is not None and not mesh.is_member:
        return None
    if n_seeds <= 0:
        raise ValueError(f"n_seeds must be positive, got {n_seeds}")
    if n_steps <= 0:
        raise ValueError(f"n_steps must be positive, got {n_steps}")
    _check_step_count(n_steps, "run_periodic_ensemble")
    if seed_chunk is None:
        # default: bound the live gap buffer near 16M float64 entries
        seed_chunk = max(1, min(n_seeds, 16_000_000 // max(1, n_steps * params.n_devices)))
    if seed_chunk <= 0:
        raise ValueError(f"seed_chunk must be positive, got {seed_chunk}")

    n_dev = params.n_devices
    period_scale = None
    if scale_to_device_periods:
        mean = process.mean_period_ms()
        if not (mean > 0):
            raise ValueError(f"process {process.name!r} has non-positive mean period {mean}")
        period_scale = params.period_ms / mean      # (N,)
    generator = torch.Generator(params.device)
    parts: list[PeriodicEnsembleResult] = []
    done, chunk_idx = 0, 0
    while done < n_seeds:
        chunk = min(seed_chunk, n_seeds - done)
        generator.manual_seed(chunk_seed(seed, chunk_idx))
        gaps = process.sample_gaps(generator, chunk * n_dev, n_steps).view(chunk, n_dev, n_steps)
        if mesh is not None:
            from repro_torch.fleet.shard import sharded_periodic_ens_scan

            carry = sharded_periodic_ens_scan(params, gaps.transpose(1, 2), mesh, jit, period_scale)
            del gaps
        else:
            buf = _gaps_buffer(gaps.transpose(1, 2))
            del gaps
            if period_scale is not None:
                buf.mul_(period_scale)
            carry = _periodic_ens_loop(params, buf, jit)
            del buf
        parts.append(_periodic_result(params, carry, n_steps, keep_device_samples))
        done += chunk
        chunk_idx += 1
    merged = _merge_periodic(parts)
    return dataclasses.replace(merged, process=process.name)


# ---------------------------------------------------------------------------
# Routed (tick-clock) ensemble — the fleet's tick body over (S, N)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoutedEnsembleResult:
    """S replications of the routed kernel; per-seed latency percentiles.

    Latency percentiles are computed per seed over every served request in
    that replication (NaN for a seed that served nothing — filter before
    interval construction).
    """

    params: FleetParams
    process: str
    n_seeds: int
    n_steps: int
    dt_ms: float
    # per-seed fleet aggregates, shape (S,)
    served: np.ndarray
    total_energy_mj: np.ndarray
    energy_per_request_mj: np.ndarray
    p50_latency_ms: np.ndarray
    p99_latency_ms: np.ndarray
    devices_alive: np.ndarray
    # per-device moments across seeds (arrays of shape (N,))
    device_served: Welford
    device_energy_mj: Welford
    # per-seed fleet-aggregate phase ledger (each axis shape (S,)); axes sum
    # to total_energy_mj within 1e-9 relative (the conservation contract)
    ledger: Optional[object] = None
    # optional full per-device samples, shape (S, N)
    per_device_served: Optional[np.ndarray] = None
    per_device_energy_mj: Optional[np.ndarray] = None

    @property
    def n_devices(self) -> int:
        return self.params.n_devices


def routed_ensemble(
    params: FleetParams,
    counts,
    dt_ms: float,
    queue_capacity: int = 16,
    keep_device_samples: bool = False,
    jit: bool = True,
) -> RoutedEnsembleResult:
    """Run S routed replications from pre-binned per-device arrival counts.

    ``counts`` is ``(S, K, N)`` int — one ``(K, N)`` direct arrival grid per
    seed (e.g. from :func:`repro_torch.core.arrivals.bin_arrival_counts`),
    moved to the fleet's device.  All S replications advance through one
    tick loop of the routed body over an ``(S, N)`` carry (CUDA graphs on a
    card when ``jit``); the per-request latency timestamps come back per
    seed for exact p50/p99 distributions.
    """
    if dt_ms <= 0:
        raise ValueError(f"dt_ms must be positive, got {dt_ms}")
    counts = torch.as_tensor(counts)
    if counts.ndim != 3 or counts.shape[2] != params.n_devices:
        raise ValueError(
            f"counts must be (n_seeds, n_steps, {params.n_devices}), got shape {tuple(counts.shape)}"
        )
    n_seeds, n_steps = int(counts.shape[0]), int(counts.shape[1])
    _check_step_count(n_steps, "routed_ensemble")
    dev = params.device
    steps = torch.arange(n_steps, dtype=torch.int64, device=dev)
    arrivals = counts.to(device=dev, dtype=torch.int32).permute(1, 0, 2)      # (K, S, N)
    leaves0 = [t.expand((n_seeds,) + tuple(t.shape)).clone() if t.ndim else t.clone()
               for t in FleetState.init(params.n_devices, queue_capacity, device=dev).leaves()]
    body = _routed_body(params, dt_ms, None, True, queue_capacity)
    carry, ys = _run_loop(body, tuple(leaves0), (steps, arrivals), n_steps, jit)
    state = FleetState.from_leaves(carry)
    served_dev = _np(state.n_served)                  # (S, N)
    energy_dev = _np(state.energy_mj)                 # (S, N)
    alive_dev = _np(state.alive)                      # (S, N)
    latency = _np(ys[4]).transpose(1, 0, 2)           # (S, K, N) f32
    served_mask = _np(ys[5]).transpose(1, 0, 2)       # (S, K, N) bool

    lat = np.where(served_mask, latency.astype(np.float64), np.nan)
    with np.errstate(invalid="ignore"), np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)                   # all-NaN seeds → NaN out
        p50 = np.nanpercentile(lat, 50.0, axis=(1, 2))
        p99 = np.nanpercentile(lat, 99.0, axis=(1, 2))

    served = served_dev.sum(axis=1)
    energy = energy_dev.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        epr = np.where(served > 0, energy / np.maximum(served, 1), np.nan)
    return RoutedEnsembleResult(
        params=params,
        process="direct",
        n_seeds=n_seeds,
        n_steps=n_steps,
        dt_ms=float(dt_ms),
        served=served,
        total_energy_mj=energy,
        energy_per_request_mj=epr,
        p50_latency_ms=p50,
        p99_latency_ms=p99,
        devices_alive=alive_dev.sum(axis=1),
        device_served=Welford().update(served_dev.astype(np.float64)),
        device_energy_mj=Welford().update(energy_dev),
        ledger=_routed_ledger(params, state),
        per_device_served=served_dev if keep_device_samples else None,
        per_device_energy_mj=energy_dev if keep_device_samples else None,
    )


def _routed_ledger(params: FleetParams, state: FleetState):
    """Per-seed fleet-aggregate ledger of a routed ensemble from the final
    carry: configuration counts split into pure configure + overhead, idle
    energy from the loop's own accumulator."""
    from repro_torch.obs.ledger import EnergyLedger

    n_cfg = _np(state.n_configs).astype(np.float64)    # (S, N)
    served = _np(state.n_served).astype(np.float64)
    ovh = _np(params.e_overhead_mj)
    cfg_pure = _np(params.e_config_mj) - ovh
    return EnergyLedger.from_axes(
        configure=(n_cfg * cfg_pure).sum(axis=1),
        compute=(served * _np(params.e_exec_mj)).sum(axis=1),
        idle=_np(state.idle_energy_mj).sum(axis=1),
        off=np.zeros(n_cfg.shape[0], dtype=np.float64),
        overhead=(n_cfg * ovh).sum(axis=1),
    )


def _merge_routed(parts: list[RoutedEnsembleResult]) -> RoutedEnsembleResult:
    first = parts[0]
    if len(parts) == 1:
        return first
    w_served, w_energy = first.device_served, first.device_energy_mj
    for p in parts[1:]:
        w_served = _merge_welford(w_served, p.device_served)
        w_energy = _merge_welford(w_energy, p.device_energy_mj)
    cat = np.concatenate
    keep = first.per_device_served is not None
    return dataclasses.replace(
        first,
        n_seeds=sum(p.n_seeds for p in parts),
        served=cat([p.served for p in parts]),
        total_energy_mj=cat([p.total_energy_mj for p in parts]),
        energy_per_request_mj=cat([p.energy_per_request_mj for p in parts]),
        p50_latency_ms=cat([p.p50_latency_ms for p in parts]),
        p99_latency_ms=cat([p.p99_latency_ms for p in parts]),
        devices_alive=cat([p.devices_alive for p in parts]),
        device_served=w_served,
        device_energy_mj=w_energy,
        ledger=_merge_ledgers([p.ledger for p in parts]),
        per_device_served=cat([p.per_device_served for p in parts]) if keep else None,
        per_device_energy_mj=cat([p.per_device_energy_mj for p in parts]) if keep else None,
    )


def run_routed_ensemble(
    params: FleetParams,
    process: ArrivalProcess,
    horizon_ms: float,
    dt_ms: float,
    n_seeds: int,
    seed: int = 0,
    seed_chunk: Optional[int] = None,
    queue_capacity: int = 16,
    max_arrivals: Optional[int] = None,
    keep_device_samples: bool = False,
) -> RoutedEnsembleResult:
    """Sample per-device streams from ``process`` for every seed and run the
    routed ensemble on the fleet's device — chunked over seeds for constant
    memory (the ``chunk × K × N`` latency trajectory is the live buffer).
    Deterministic in ``(seed, seed_chunk)`` — see
    :func:`run_periodic_ensemble`."""
    if n_seeds <= 0:
        raise ValueError(f"n_seeds must be positive, got {n_seeds}")
    n_dev = params.n_devices
    n_steps = int(math.ceil(horizon_ms / dt_ms))
    if seed_chunk is None:
        seed_chunk = max(1, min(n_seeds, 8_000_000 // max(1, n_steps * n_dev)))
    generator = torch.Generator(params.device)
    parts: list[RoutedEnsembleResult] = []
    done, chunk_idx = 0, 0
    while done < n_seeds:
        chunk = min(seed_chunk, n_seeds - done)
        generator.manual_seed(chunk_seed(seed, chunk_idx))
        times = process.sample_batch(generator, chunk * n_dev, horizon_ms, max_arrivals=max_arrivals)
        counts = bin_arrival_counts(times, horizon_ms, dt_ms)
        counts = counts.reshape(n_steps, chunk, n_dev).permute(1, 0, 2)
        parts.append(
            routed_ensemble(
                params, counts, dt_ms,
                queue_capacity=queue_capacity,
                keep_device_samples=keep_device_samples,
            )
        )
        done += chunk
        chunk_idx += 1
    merged = _merge_routed(parts)
    return dataclasses.replace(merged, process=process.name)
