"""Fleet transition kernels: N devices advanced tick by tick (port of
``repro.fleet.step``).

Two step semantics, sharing :class:`~repro_torch.fleet.state.FleetParams`:

**Periodic** (:func:`run_periodic`) — every device sees its own constant
request period (the paper's duty-cycle mode); one step = one request per
device.  Admission recomputes the *closed-form affine* cumulative energy
each step — the same per-item/idle/init costs as
:mod:`repro_torch.core.batch_eval`'s kernels, in the same IEEE-754
association order as the scalar event loop:

    On-Off       cum(n) = n · E_item^OnOff
    Idle-Waiting cum(n) = E_init + n · E_item^IW + (n−1) · E_idle

admit item ``n`` iff ``cum(n) ≤ budget + FLOOR_EPS · per_period`` — the
scalar ``simulate(mode="step")`` rule, so an N=1 fleet reproduces the scalar
oracle's ``n_items`` exactly and its energy bit for bit (final energies are
re-derived from the admitted counts through the identical expression the
oracle uses).

**Routed** (:func:`run_routed`) — a global clock advances in ``dt_ms``
ticks; a router (:mod:`repro_torch.fleet.router`) splits each tick's global
request count across devices, requests wait in per-device FIFO ring buffers
(arrival timestamps, so latency percentiles are exact), and each device
serves at most one request per tick under ``simulate_trace``'s charging
rules: the idle span since the last completion (capped at the policy's
timeout), a (re)configuration when off or released, then the execution
phases — admitted only if all of it fits the remaining budget, after which
the device is dead.

**The tick loop.**  The reference's ``lax.scan`` becomes a loop over ticks
of one body function (:func:`_run_loop`).  The body never synchronises with
the host (no ``.item()``, no boolean-mask indexing, no ``nonzero``).  With
``jit=True`` (the reference's own flag and default) on a CUDA device, the
body over a chunk of :data:`GRAPH_CHUNK` ticks is captured once into a CUDA
graph and replayed chunk after chunk; a capture that fails raises.  With
``jit=False``, and always on the CPU, the loop runs eagerly: the graph
path's oracle, the same kernels in the same order, so the two agree bit for
bit.  Every division takes a tensor divisor on the fleet's device (a CUDA
tensor divided by a host scalar is a product with its reciprocal).  The
routed tick's idle energy is ``P · t · (1/1000)``, the product the
reference's compiled scan computes, not the scalar simulator's
``P · t / 1000``: the two differ in the last bit for some inputs, so the
routed energies equal the reference's bit for bit and ``simulate_trace``'s
within 1e-9 relative, as in the reference's own tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.fleet.router import ROUTER_CODES, route_counts
from repro_torch.fleet.state import FleetParams, FleetState

__all__ = [
    "GRAPH_CHUNK",
    "INT32_STEP_LIMIT",
    "PeriodicFleetResult",
    "RoutedFleetResult",
    "routed_ledger",
    "run_periodic",
    "run_routed",
]

#: simulate_trace's admission epsilon (relative to max(1, cost)).
_TRACE_EPS = 1e-9

#: 1/1000 in double: ms·mW → mJ as the reference's compiled tick computes it.
_INV_1000 = 1.0 / 1000.0

#: Capacity of the int32 per-device step counter the periodic loop carries
#: (see ``repro_torch.fleet.dtypes`` for the carry-dtype audit).  Guarded
#: explicitly at every entry point rather than silently wrapping.
INT32_STEP_LIMIT = 2**31 - 1

#: Loop iterations captured into one CUDA graph (``jit=True`` on a card).
GRAPH_CHUNK = 64

#: Elements (ticks × devices) one periodic step evaluates: a small fleet
#: advances many ticks per step, a large one one tick (see
#: :func:`_periodic_body`).
_PERIODIC_BLOCK_ELEMS = 1 << 20


def _check_step_count(n_steps: int, where: str) -> None:
    if n_steps > INT32_STEP_LIMIT:
        raise OverflowError(
            f"{where}: n_steps={n_steps} exceeds the int32 step-counter "
            f"capacity ({INT32_STEP_LIMIT}); the loop carries int32 "
            "admission counters (repro_torch.fleet.dtypes) — split the horizon "
            "or widen the carry deliberately"
        )


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# The tick loop: eager, or CUDA graphs over chunks
# ---------------------------------------------------------------------------
Body = Callable[[tuple, tuple], tuple]


def _run_loop(body: Body, carry: tuple, xs: tuple, n: int, jit: bool) -> tuple[tuple, tuple]:
    """``n`` iterations of ``body(carry, x) -> (carry, ys)``, x the k-th row
    of every tensor in ``xs``; returns the final carry and each output
    stacked over the iterations."""
    carry = tuple(carry)
    if n == 0:
        # one discarded step gives the outputs' shapes and dtypes
        _, ys = body(carry, tuple(x.new_zeros(x.shape[1:]) for x in xs))
        return carry, tuple(y.new_empty((0,) + y.shape) for y in ys)
    if jit and carry[0].device.type == "cuda":
        return _graph_loop(body, carry, xs, n)
    outs = None
    for k in range(n):
        carry, ys = body(carry, tuple(x[k] for x in xs))
        if outs is None:
            outs = [y.new_empty((n,) + y.shape) for y in ys]
        for o, y in zip(outs, ys):
            o[k] = y
    return carry, tuple(outs)


def _capture(body: Body, static_carry: list, xs: tuple, m: int):
    """One CUDA graph of ``m`` body iterations that reads ``static_carry``,
    writes the new carry back into it, reads its inputs from the returned
    static input buffers and leaves its stacked outputs in the returned
    static output tensors."""
    static_x = [x.new_zeros((m,) + x.shape[1:]) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # warm-up outside the capture (lazy initialisation of the ops used)
        body(tuple(c.clone() for c in static_carry), tuple(b[0] for b in static_x))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = tuple(static_carry)
        steps = []
        for j in range(m):
            c, ys = body(c, tuple(b[j] for b in static_x))
            steps.append(ys)
        static_y = [torch.stack([ys[i] for ys in steps]) for i in range(len(steps[0]))]
        for dst, src in zip(static_carry, c):
            dst.copy_(src)
    return graph, static_x, static_y


def _graph_loop(body: Body, carry: tuple, xs: tuple, n: int) -> tuple[tuple, tuple]:
    static_carry = [c.clone() for c in carry]
    graphs: dict[int, tuple] = {}
    outs = None
    s = 0
    while s < n:
        m = min(GRAPH_CHUNK, n - s)
        if m not in graphs:
            graphs[m] = _capture(body, static_carry, xs, m)
        graph, static_x, static_y = graphs[m]
        for buf, x in zip(static_x, xs):
            buf.copy_(x[s : s + m])
        graph.replay()
        if outs is None:
            outs = [y.new_empty((n,) + y.shape[1:]) for y in static_y]
        for o, y in zip(outs, static_y):
            o[s : s + m].copy_(y)
        s += m
    return tuple(static_carry), tuple(outs)


# ---------------------------------------------------------------------------
# Periodic kernel
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PeriodicFleetResult:
    """Final fleet state after ``n_steps`` request periods per device
    (tensors on the fleet's device)."""

    params: FleetParams
    n_steps: int
    n_items: torch.Tensor           # i64 (N,) — items admitted within budget
    energy_mj: torch.Tensor         # f64 (N,) — cumulative energy (oracle-exact)
    lifetime_ms: torch.Tensor       # f64 (N,) — n_items · period
    alive: torch.Tensor             # bool (N,) — still admitting at horizon end
    alive_over_time: torch.Tensor   # i32 (n_steps,) — devices alive per step

    def ledger(self):
        """Per-device phase-resolved :class:`repro_torch.obs.ledger.EnergyLedger`
        (shape ``(N,)`` per axis), derived from the admitted counts through
        the same closed forms as ``energy_mj`` — axes sum to ``energy_mj``
        within 1e-9 relative (the conservation contract)."""
        from repro_torch.obs.ledger import EnergyLedger

        p = self.params
        n_items = _np(self.n_items)
        nf = n_items.astype(np.float64)
        any_items = (n_items > 0).astype(np.float64)
        is_onoff = _np(p.is_onoff)
        ovh = _np(p.e_overhead_mj)
        cfg_pure = _np(p.e_config_mj) - ovh
        # On-Off pays configure+overhead per item; Idle-Waiting once (E_init)
        n_cfg = np.where(is_onoff, nf, any_items)
        idle = np.where(is_onoff, 0.0, any_items * (nf - 1.0) * _np(p.e_idle_mj))
        return EnergyLedger.from_axes(
            configure=n_cfg * cfg_pure,
            compute=nf * _np(p.e_exec_mj),
            idle=idle,
            off=np.zeros_like(nf),
            overhead=n_cfg * ovh,
        )


def _periodic_limit(params: FleetParams):
    """Per-device admission limit: budget + FLOOR_EPS of one nominal period
    (the scalar ``simulate(mode="step")`` boundary rule)."""
    per_period = params.e_item_mj + params.e_idle_mj   # e_idle = 0 for On-Off
    return params.e_budget_mj + em.FLOOR_EPS * per_period


def _periodic_body(params: FleetParams, limit, ticks: int = 1):
    """The periodic admission step over ``ticks`` consecutive ticks at once.

    Carry: ``(n int32, alive bool)``; output: the admitted count of each of
    the ``ticks`` ticks as int32.  One tick of the reference's scan admits
    device d iff it is alive and ``cum(n + 1) ≤ limit``, and a device that
    fails once stays dead; so tick j of a block admits iff the device
    entered the block alive and ``cum(n0 + i) ≤ limit`` for every i ≤ j —
    the same cumulative energies, bit for bit, evaluated for the whole block
    in one (ticks × N) tensor.  ``ticks = 1`` is the reference's step.
    """
    j = torch.arange(1, ticks + 1, dtype=torch.int32, device=params.device)[:, None]
    ok0 = params.feasible

    def body(carry, _=None):
        n, alive = carry
        nf = (n + j).to(torch.float64)                       # candidates n+1 … n+ticks
        a = nf * params.e_item_mj
        cum = torch.where(params.is_onoff, a, params.e_init_mj + a + (nf - 1.0) * params.e_idle_mj)
        run = torch.cumsum((cum <= limit).to(torch.int32), dim=0) == j
        admit = (alive & ok0) & run
        n = n + admit.sum(dim=0, dtype=torch.int32)
        return (n, admit[-1]), (admit.sum(dim=1, dtype=torch.int32),)

    return body


def _periodic_carry0(params: FleetParams):
    n0 = torch.zeros(params.period_ms.shape, dtype=torch.int32, device=params.device)
    alive0 = torch.ones(params.period_ms.shape, dtype=torch.bool, device=params.device)
    return n0, alive0


def _periodic_final(params: FleetParams, n):
    """Final energies/lifetimes re-derived from the admitted counts —
    op-for-op the scalar fast path (``onoff_cumulative_energy_mj`` /
    ``idlewait_cumulative_energy_mj``)."""
    nf = n.to(torch.float64)
    a = nf * params.e_item_mj
    energy = torch.where(
        params.is_onoff,
        a,
        torch.where(n > 0, params.e_init_mj + a + (nf - 1.0) * params.e_idle_mj, 0.0),
    )
    lifetime = nf * params.period_ms
    return energy, lifetime


def _periodic_ticks(n_devices: int, n_steps: int) -> int:
    return max(1, min(n_steps, _PERIODIC_BLOCK_ELEMS // n_devices))


def _periodic_steps(params: FleetParams, limit, carry, n_steps: int, jit: bool):
    """``n_steps`` periodic steps from ``carry``, in blocks of
    :func:`_periodic_ticks` ticks; returns the new carry and the admitted
    count of each step (int32).  The sharded runner calls it a chunk at a
    time on each shard."""
    ticks = _periodic_ticks(params.n_devices, n_steps)
    n_blocks, rem = divmod(n_steps, ticks)
    pieces = []
    for count, width in ((n_blocks, ticks), (1 if rem else 0, rem)):
        if count:
            carry, (ys,) = _run_loop(_periodic_body(params, limit, width), carry, (), count, jit)
            pieces.append(ys.reshape(-1))
    alive_ts = (torch.cat(pieces) if pieces
                else torch.zeros(0, dtype=torch.int32, device=params.device))
    return carry, alive_ts


def run_periodic(params: FleetParams, n_steps: int, jit: bool = True) -> PeriodicFleetResult:
    """Advance every device through ``n_steps`` of its own request period,
    on the fleet's device.

    ``n_items`` is capped by the horizon: a device that would outlive
    ``n_steps`` requests reports ``n_items == n_steps`` with ``alive`` still
    True.  Choose ``n_steps ≥ n_max`` (e.g. from
    :func:`repro_torch.core.batch_eval.evaluate_idlewait_batch`) for
    full-lifetime questions.
    """
    if n_steps < 0:
        raise ValueError(f"n_steps must be non-negative, got {n_steps}")
    _check_step_count(n_steps, "run_periodic")
    carry, alive_ts = _periodic_steps(params, _periodic_limit(params), _periodic_carry0(params),
                                      n_steps, jit)
    n, alive = carry
    energy, lifetime = _periodic_final(params, n)
    return PeriodicFleetResult(
        params=params,
        n_steps=n_steps,
        n_items=n.to(torch.int64),
        energy_mj=energy,
        lifetime_ms=lifetime,
        alive=alive,
        alive_over_time=alive_ts,
    )


# ---------------------------------------------------------------------------
# Routed kernel
# ---------------------------------------------------------------------------
def routed_ledger(params: FleetParams, state: FleetState):
    """Per-device phase-resolved :class:`repro_torch.obs.ledger.EnergyLedger`
    (shape ``(N,)`` per axis) for any routed-kernel :class:`FleetState`:
    configurations split into the pure configure energy and the power-up
    overhead, idle energy from the loop's own accumulator — axes sum to
    ``state.energy_mj`` within 1e-9 relative."""
    from repro_torch.obs.ledger import EnergyLedger

    n_cfg = _np(state.n_configs).astype(np.float64)
    served = _np(state.n_served).astype(np.float64)
    ovh = _np(params.e_overhead_mj)
    cfg_pure = _np(params.e_config_mj) - ovh
    return EnergyLedger.from_axes(
        configure=n_cfg * cfg_pure,
        compute=served * _np(params.e_exec_mj),
        idle=_np(state.idle_energy_mj),
        off=np.zeros_like(served),
        overhead=n_cfg * ovh,
    )


@dataclasses.dataclass(frozen=True)
class RoutedFleetResult:
    """Final state + per-tick trajectories of a routed-traffic run (tensors
    on the fleet's device)."""

    params: FleetParams
    state: FleetState                   # final carry
    dt_ms: float
    n_steps: int
    router: Optional[str]               # None = per-device streams ("direct")
    alive_over_time: torch.Tensor       # i32 (K,)
    served_over_time: torch.Tensor      # i32 (K,)
    queued_over_time: torch.Tensor      # i32 (K,)
    latency_ms: Optional[torch.Tensor]  # f32 (K, N) — served-request latency
    served_mask: Optional[torch.Tensor]  # bool (K, N)
    # state-transition event masks, populated with collect_events=True
    reconfig_mask: Optional[torch.Tensor] = None     # bool (K, N) — serve paid a config
    released_mask: Optional[torch.Tensor] = None     # bool (K, N) — timeout release
    queue_depth: Optional[torch.Tensor] = None       # i32 (K, N) — post-tick backlog
    dropped_per_tick: Optional[torch.Tensor] = None  # i32 (K, N) — overflow drops
    start_tick: int = 0                 # global tick of this chunk's first step

    @property
    def n_served(self) -> torch.Tensor:
        return self.state.n_served

    @property
    def energy_mj(self) -> torch.Tensor:
        return self.state.energy_mj

    def ledger(self):
        """Per-device phase-resolved ledger — see :func:`routed_ledger`."""
        return routed_ledger(self.params, self.state)

    def final_modes(self) -> np.ndarray:
        """Per-device mode codes at horizon end (state.MODE_*): DEAD if the
        budget is exhausted, BUSY if still mid-service, IDLE if resident
        within its timeout, OFF otherwise (never configured or released)."""
        from repro_torch.fleet.state import MODE_BUSY, MODE_DEAD, MODE_IDLE, MODE_OFF

        end_ms = self.dt_ms * (self.start_tick + self.n_steps)
        alive = _np(self.state.alive)
        resident = _np(self.state.resident)
        completion = _np(self.state.completion_ms)
        served = _np(self.state.n_served) > 0
        timed_out = _np(self.params.timeout_ms) < (end_ms - completion)
        return np.where(
            ~alive,
            MODE_DEAD,
            np.where(
                served & (completion > end_ms),
                MODE_BUSY,
                np.where(resident & served & ~timed_out, MODE_IDLE, MODE_OFF),
            ),
        )


def _routed_body(params: FleetParams, dt_ms, router_code: Optional[int],
                 collect_latency: bool, capacity: int,
                 collect_events: bool = False):
    """Build the tick body; ``router_code`` None means per-device counts.

    ``collect_events=True`` appends per-tick state-transition outputs
    (reconfigure / release masks, queue depth, drops) after the latency
    outputs.  Existing output indices are unchanged.

    With per-device counts the carry may hold leading axes before the
    device axis — the Monte Carlo ensemble's ``(S, N)`` seeds × devices
    (:func:`repro_torch.mc.ensemble.routed_ensemble`): every per-device op
    is elementwise or acts on the last axis, and the fleet-wide outputs sum
    over the device axis only, so each seed stays its own fleet."""
    dev = params.device
    dt = torch.full((), float(dt_ms), dtype=torch.float64, device=dev)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    no_drops = torch.zeros((), dtype=torch.int64, device=dev)

    def body(carry, x):
        state = FleetState.from_leaves(carry)
        k, arr = x
        now = k.to(torch.float64) * dt

        if router_code is None:
            counts = arr.to(torch.int32)
            rr_next = state.rr_ptr
            unrouted = no_drops
        else:
            counts, rr_next = route_counts(
                arr, router_code, state.alive, state.q_len,
                state.energy_mj, params.e_budget_mj, state.rr_ptr,
            )
            # requests no alive device could take (counts sums to the global
            # stream otherwise); queue overflow is tracked per device below
            unrouted = arr.to(torch.int64) - counts.sum(dim=-1, dtype=torch.int64)

        # ---- enqueue: masked ring-buffer fill (all arrivals stamp `now`) ----
        space = capacity - state.q_len
        acc = torch.minimum(counts, space)
        rel = (slots - (state.q_head + state.q_len)[..., None]) % capacity
        queue_ms = torch.where(rel < acc[..., None], now, state.queue_ms)
        q_len = state.q_len + acc

        # ---- serve at most one queued request per device this tick ---------
        free = state.alive & (q_len > 0) & (now >= state.completion_ms)
        head_ts = torch.gather(queue_ms, -1, state.q_head[..., None].to(torch.int64))[..., 0]
        # The *policy-managed* idle span is the time the device sat with an
        # empty queue: from its last completion until the head request
        # *arrived* (simulate_trace's start = max(a, completion)) — only
        # that span is subject to the timeout/release decision, so a
        # backlogged request cannot trigger a phantom release.  A device that
        # did NOT release stays resident through the remaining hold until
        # this service tick and is charged idle power for all of it.
        head_ready = torch.maximum(head_ts, state.completion_ms)
        gap_policy = head_ready - state.completion_ms
        managed = (state.n_served > 0) & state.resident
        released = managed & (params.timeout_ms < gap_policy)
        # the remaining *hold* until this service tick is charged at idle
        # power only for policies that keep the device resident at all
        hold = torch.where(params.timeout_ms > 0, now - head_ready, 0.0)
        idle_t = torch.where(
            managed, torch.where(released, params.timeout_ms, gap_policy + hold), 0.0
        )
        # the reference's compiled scan folds ``/ 1000.0`` into a product
        # with the reciprocal (as XLA does for every constant divisor); the
        # port multiplies by the same double, so the two agree bit for bit
        idle_e = params.p_idle_mw * idle_t * _INV_1000
        reconfig = ~state.resident | released
        cost = idle_e + torch.where(reconfig, params.e_config_mj, 0.0) + params.e_exec_mj
        fits = state.energy_mj + cost <= params.e_budget_mj + _TRACE_EPS * torch.clamp_min(cost, 1.0)
        serve = free & fits
        # a device whose next admission no longer fits is exhausted for good
        alive = state.alive & ~(free & ~fits)

        inline_cfg = serve & reconfig & (state.n_configs > 0)
        start = now + torch.where(inline_cfg, params.t_config_ms, 0.0)
        completion = torch.where(serve, start + params.t_exec_ms, state.completion_ms)
        energy = state.energy_mj + torch.where(serve, cost, 0.0)
        q_len_next = q_len - serve.to(torch.int32)

        new_state = FleetState(
            energy_mj=energy,
            # the idle-waiting share of the same accumulation (ledger axis)
            idle_energy_mj=state.idle_energy_mj + torch.where(serve, idle_e, 0.0),
            n_served=state.n_served + serve.to(torch.int64),
            n_configs=state.n_configs + (serve & reconfig).to(torch.int64),
            n_released=state.n_released + (serve & released).to(torch.int64),
            n_dropped=state.n_dropped + (counts - acc).to(torch.int64),
            resident=state.resident | serve,
            alive=alive,
            completion_ms=completion,
            queue_ms=queue_ms,
            q_head=torch.where(serve, (state.q_head + 1) % capacity, state.q_head),
            q_len=q_len_next,
            rr_ptr=rr_next,
        )
        ys = (
            alive.sum(dim=-1, dtype=torch.int32),
            serve.sum(dim=-1, dtype=torch.int32),
            q_len_next.sum(dim=-1, dtype=torch.int32),
            unrouted,
        )
        if collect_latency:
            latency = torch.where(serve, completion - head_ts, 0.0)
            ys = ys + (latency.to(torch.float32), serve)
        if collect_events:
            ys = ys + (
                serve & reconfig,
                serve & released,
                q_len_next,
                (counts - acc).to(torch.int32),
            )
        return new_state.leaves(), ys

    return body


def run_routed(
    params: FleetParams,
    arrivals,
    dt_ms: float,
    router: Optional[str] = "round_robin",
    queue_capacity: int = 16,
    collect_latency: bool = True,
    collect_events: bool = False,
    jit: bool = True,
    state0: Optional[FleetState] = None,
    start_tick: int = 0,
) -> RoutedFleetResult:
    """Simulate routed traffic over ``K = len(arrivals)`` ticks of ``dt_ms``
    on the fleet's device.

    ``arrivals`` is either a ``(K,)`` int array — the *global* per-tick
    request counts a router distributes — or a ``(K, N)`` int array of
    per-device counts (``router=None``/"direct", e.g. from
    :func:`repro_torch.core.arrivals.bin_arrival_counts`).  Service rate is
    capped at one request per device per tick, so pick ``dt_ms`` at or
    below the per-device inter-arrival scale.  ``jit=True`` replays CUDA
    graphs of the tick body on a card (see the module docstring).

    **Chunked continuation.** Passing ``state0`` (a previous run's
    ``result.state``) and ``start_tick`` (previous ``start_tick + n_steps``)
    resumes the global clock mid-stream: the loop's ``now = k * dt_ms``
    values are the same ones a single full-length run would compute, and the
    carry is handed over unchanged, so a chain of chunked calls is
    *bit-identical* to one call over the concatenated arrivals (per-chunk
    global-drop roll-ups onto device 0 are integer sums, hence exact).  When
    ``state0`` is given the queue capacity is taken from it and
    ``queue_capacity`` is ignored.
    """
    if dt_ms <= 0:
        raise ValueError(f"dt_ms must be positive, got {dt_ms}")
    if start_tick < 0:
        raise ValueError(f"start_tick must be non-negative, got {start_tick}")
    device = params.device
    arrivals = torch.as_tensor(arrivals)
    if arrivals.ndim == 1:
        if router is None or router == "direct":
            raise ValueError("1-D arrivals (a global stream) need a router policy")
        code: Optional[int] = ROUTER_CODES[router]
    elif arrivals.ndim == 2:
        if arrivals.shape[1] != params.n_devices:
            raise ValueError(
                f"per-device arrivals have {arrivals.shape[1]} columns for "
                f"{params.n_devices} devices"
            )
        if router not in (None, "direct"):
            raise ValueError("per-device (K, N) arrivals are already routed; use router=None")
        code = None
        router = None
    else:
        raise ValueError(f"arrivals must be (K,) or (K, N), got shape {tuple(arrivals.shape)}")
    n_steps = int(arrivals.shape[0])
    _check_step_count(start_tick + n_steps, "run_routed")
    arrivals = arrivals.to(device=device, dtype=torch.int32)
    steps = torch.arange(start_tick, start_tick + n_steps, dtype=torch.int64, device=device)
    if state0 is None:
        state0 = FleetState.init(params.n_devices, queue_capacity, device=device)
    else:
        if int(state0.energy_mj.shape[0]) != params.n_devices:
            raise ValueError(
                f"state0 carries {int(state0.energy_mj.shape[0])} devices "
                f"for {params.n_devices}-device params"
            )
        queue_capacity = state0.queue_capacity
    body = _routed_body(params, dt_ms, code, collect_latency, queue_capacity, collect_events)
    carry, ys = _run_loop(body, state0.leaves(), (steps, arrivals), n_steps, jit)
    state = FleetState.from_leaves(carry)
    if code is not None:
        # global drops (dead fleet / unroutable) land on device 0's ledger so
        # totals stay conserved
        n_dropped = state.n_dropped.clone()
        n_dropped[:1] += ys[3].sum()
        state = dataclasses.replace(state, n_dropped=n_dropped)
    return RoutedFleetResult(
        params=params,
        state=state,
        dt_ms=float(dt_ms),
        n_steps=n_steps,
        router=router,
        alive_over_time=ys[0],
        served_over_time=ys[1],
        queued_over_time=ys[2],
        latency_ms=ys[4] if collect_latency else None,
        served_mask=ys[5] if collect_latency else None,
        reconfig_mask=ys[-4] if collect_events else None,
        released_mask=ys[-3] if collect_events else None,
        queue_depth=ys[-2] if collect_events else None,
        dropped_per_tick=ys[-1] if collect_events else None,
        start_tick=start_tick,
    )
