"""Vectorized batch evaluation engine for the paper's sweeps (port of
``repro.core.batch_eval``, torch tensors in float64 on one device).

Every headline result of the paper is a *sweep*: 66 configuration-parameter
combinations (Exp. 1), request-period sweeps locating the Idle-Waiting/On-Off
crossover (Exp. 2), and lifetime curves under the 4147 J budget (Exp. 3).
The scalar path (:mod:`repro_torch.core.energy_model`,
:mod:`repro_torch.core.config_phase`) evaluates one point per Python call;
this module expresses the same closed forms as tensor programs, so one call
evaluates an entire grid on the card.

Axis layout
-----------
The full design-space grid is a dense 7-axis broadcast; every tensor a
:class:`GridResult` carries has this shape (axes of size 1 broadcast):

    ==== ======================= =================================
    axis meaning                 source
    ==== ======================= =================================
    0    device                  :class:`~repro_torch.core.config_phase.FpgaDevice`
    1    SPI buswidth            Table 1
    2    SPI clock (MHz)         Table 1
    3    bitstream compression   Table 1
    4    request period (ms)     Exp. 2 x-axis
    5    idle-power method       Table 3
    6    energy budget (mJ)      Eq. 3
    ==== ======================= =================================

Sparse broadcasting (each 1-D axis reshaped onto its own dimension) keeps
memory at O(Σ axis) until the final element-wise ops, so a 10M-point grid
costs one output-sized buffer per quantity, not seven.

Bit-agreement contract
----------------------
The scalar path is the *reference oracle*: every quantity here is computed
with the identical sequence of IEEE-754 double ops as its scalar counterpart
(same association order, same :data:`~repro_torch.core.energy_model.FLOOR_EPS`
floor convention).  Torch runs eagerly, one correctly rounded op per
kernel, on the CPU and on the card alike, so ``n_max`` matches the scalar
path *exactly* and energies/lifetimes bit for bit on every device.  Two
torch conventions would break that and are avoided: a CUDA tensor divided
by a host scalar is computed as a product with the scalar's reciprocal, and
``number / tensor`` is ``tensor.reciprocal() * number`` everywhere — so
every division here goes through :func:`_div` with both operands tensors on
the same device.  No fused op (``addcmul``, ``lerp``, ``torch.compile``) is
used: a contraction into an FMA rounds once where the oracle rounds twice.

The reference's ``jit=`` flag (XLA fusion) has no counterpart; the functions
take ``device=`` instead (default ``"cuda"``, which raises on a host without a
card; ``"cpu"`` runs the same program on the host).

Examples
--------
>>> from repro_torch.core.batch_eval import config_phase_grid
>>> from repro_torch.core.config_phase import SPARTAN7_XC7S15
>>> g = config_phase_grid(SPARTAN7_XC7S15, device="cpu")
>>> tuple(g["config_energy_mj"].shape)    # (device, buswidth, clock, compression)
(1, 3, 11, 2)
>>> e = g["config_energy_mj"]
>>> round(float(e.min()), 2), round(float(e.max() / e.min()), 2)
(11.85, 40.12)
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.config_phase import (
    COMPRESSION_OPTIONS,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    FpgaDevice,
    SPARTAN7_XC7S15,
    _validate_grid_axis,
)
from repro_torch.core.phases import CONFIGURATION, WorkloadItem, paper_lstm_item
from repro_torch.core.strategies import IDLE_POWER_MW, IdlePowerMethod
from repro_torch.device import resolve_device

__all__ = [
    "DeviceArrays",
    "ItemArrays",
    "BatchStrategyResult",
    "GridResult",
    "SweepGrid",
    "GRID_QUANTITIES",
    "grid_axes",
    "config_phase_grid",
    "evaluate_onoff_batch",
    "evaluate_idlewait_batch",
    "evaluate_adaptive_batch",
    "crossover_batch",
    "sweep_batch",
    # differentiable primitives (the optimizer builds on these)
    "config_phase_kernel",
    "crossover_kernel",
    "idle_energy_kernel",
    "onoff_n_smooth",
    "idlewait_n_smooth",
]

_F64 = torch.float64


def _arr(x, device) -> torch.Tensor:
    """To a float64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def _div(a, b) -> torch.Tensor:
    """``a / b`` correctly rounded on every device (see the module
    docstring): a Python number on either side becomes a 0-d tensor on the
    other side's device before the division."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), float(a), dtype=_F64, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=_F64, device=a.device)
    return torch.div(a, b)


def _py_sum(terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """Element-wise ``sum(terms)`` as the running interpreter's built-in
    ``sum()`` computes it on Python floats — the scalar path's phase totals
    (``WorkloadItem.total_energy_mj``/``total_time_ms``).  Before Python
    3.12 that is a left fold; from 3.12 on, CPython compensates the fold
    (Neumaier: the running error is carried in ``c`` and added once at the
    end when it is non-zero and finite), and the total can differ from the
    plain fold in its last bit."""
    total = 0.0 + terms[0]
    if sys.version_info < (3, 12):
        for x in terms[1:]:
            total = total + x
        return total
    c = torch.zeros_like(total)
    for x in terms[1:]:
        t = total + x
        c = c + torch.where(total.abs() >= x.abs(), (total - t) + x, (x - t) + total)
        total = t
    return torch.where((c != 0) & torch.isfinite(c), total + c, total)


def grid_axes(*axes: Sequence[float], device="cuda") -> tuple[torch.Tensor, ...]:
    """Reshape 1-D axes for sparse broadcasting: axis i becomes shape
    ``(1,)*i + (len,) + (1,)*(n-1-i)`` — the outer product without
    materializing the dense mesh."""
    device = resolve_device(device)
    n = len(axes)
    out = []
    for i, ax in enumerate(axes):
        a = _arr(np.atleast_1d(np.asarray(ax, dtype=np.float64)), device)
        shape = [1] * n
        shape[i] = a.shape[0]
        out.append(a.reshape(shape))
    return tuple(out)


# ---------------------------------------------------------------------------
# Structure-of-arrays views of the scalar dataclasses
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceArrays:
    """Structure-of-arrays view of one or more :class:`FpgaDevice`, shape (D,)."""

    names: tuple[str, ...]
    bitstream_bits: torch.Tensor
    compression_ratio: torch.Tensor
    setup_time_ms: torch.Tensor
    setup_power_mw: torch.Tensor
    p_static_load_mw: torch.Tensor
    k_io_mw_per_lane_mhz: torch.Tensor
    k_comp_mw_per_lane_mhz: torch.Tensor

    @staticmethod
    def from_devices(devices: Sequence[FpgaDevice], device="cuda") -> "DeviceArrays":
        if not devices:
            raise ValueError("DeviceArrays needs at least one device")
        device = resolve_device(device)
        cols = {
            f.name: _arr([getattr(d, f.name) for d in devices], device)
            for f in dataclasses.fields(FpgaDevice)
            if f.name != "name"
        }
        return DeviceArrays(names=tuple(d.name for d in devices), **cols)

    def reshape(self, shape: Sequence[int]) -> "DeviceArrays":
        """Place the device axis into a broadcast layout (e.g. axis 0 of 7)."""
        return dataclasses.replace(
            self, **{k: v.reshape(shape) for k, v in self.cols().items()}
        )

    def cols(self) -> dict[str, torch.Tensor]:
        """Field tensors as a plain dict (what the kernels take)."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "names"
        }


@dataclasses.dataclass(frozen=True)
class ItemArrays:
    """Per-item scalar quantities of a :class:`WorkloadItem` as 0-d tensors.

    The values are computed by the item's own Python properties (the exact
    scalar code path, including its left-to-right ``sum()`` association
    order), then wrapped — so the batched closed forms start from
    bit-identical inputs.
    """

    e_exec_mj: torch.Tensor     # execution energy per item (E_item^IW)
    t_exec_ms: torch.Tensor     # execution latency (T_latency^IW)
    e_config_mj: torch.Tensor   # configuration energy
    t_config_ms: torch.Tensor   # configuration time
    e_total_mj: torch.Tensor    # all phases (On-Off per-item energy, pre-powerup)
    t_total_ms: torch.Tensor    # all phases (On-Off latency)
    idle_power_mw: torch.Tensor

    @staticmethod
    def from_item(item: WorkloadItem, device="cuda") -> "ItemArrays":
        device = resolve_device(device)
        return ItemArrays(
            e_exec_mj=_arr(item.execution_energy_mj, device),
            t_exec_ms=_arr(item.execution_time_ms, device),
            e_config_mj=_arr(item.config_energy_mj, device),
            t_config_ms=_arr(item.config_time_ms, device),
            e_total_mj=_arr(item.total_energy_mj, device),
            t_total_ms=_arr(item.total_time_ms, device),
            idle_power_mw=_arr(item.idle_power_mw, device),
        )


# ---------------------------------------------------------------------------
# Array kernels: the closed forms of energy_model.py / config_phase.py,
# op-for-op.  All run element-wise over broadcastable float64 tensors.
# ---------------------------------------------------------------------------
def _floor_n(x):
    return torch.floor(x + em.FLOOR_EPS).to(torch.int64)


def _onoff_n_max(e_item, budget):
    return _floor_n(_div(budget, e_item))


def _idle_energy(p_idle, t_req, t_exec):
    # idle_energy_mj: p_idle * (t_req - t_exec) / 1000.0
    return _div(p_idle * (t_req - t_exec), 1000.0)


def _idlewait_n_max(e_init, e_exec, e_idle, budget):
    # idlewait_n_max: floor((B - E_init + e_idle) / (e_item + e_idle)), ≥ 0
    per_period = e_exec + e_idle
    return torch.clamp_min(_floor_n(_div(budget - e_init + e_idle, per_period)), 0)


def _crossover(e_onoff, e_exec, t_exec, p_idle):
    # crossover_period_ms: (E_onoff - E_iw) / (P_idle/1000) + T_lat^IW ; inf at P_idle ≤ 0
    safe = torch.where(p_idle > 0, p_idle, 1.0)
    t = _div(e_onoff - e_exec, _div(safe, 1000.0)) + t_exec
    return torch.where(p_idle > 0, t, torch.inf)


def _config_grid_kernel(dev: Mapping[str, torch.Tensor], w, f, c):
    """config_phase.FpgaDevice stage models over broadcast tensors."""
    lanes = w * f                                   # ConfigParams.lanes_mhz
    load_bits = dev["bitstream_bits"] * torch.where(c, dev["compression_ratio"], 1.0)
    load_time = _div(_div(load_bits, lanes), 1000.0)   # load_time_ms
    k = dev["k_io_mw_per_lane_mhz"] + torch.where(c, dev["k_comp_mw_per_lane_mhz"], 0.0)
    load_power = dev["p_static_load_mw"] + k * lanes   # load_power_mw
    load_energy = _div(load_power * load_time, 1000.0)   # energy_mj(P, T)
    setup_energy = _div(dev["setup_power_mw"] * dev["setup_time_ms"], 1000.0)
    config_time = dev["setup_time_ms"] + load_time
    config_energy = setup_energy + load_energy
    config_power = _div(1000.0 * config_energy, config_time)
    return {
        "load_time_ms": load_time,
        "load_power_mw": load_power,
        "load_energy_mj": load_energy,
        "config_time_ms": config_time,
        "config_power_mw": config_power,
        "config_energy_mj": config_energy,
    }


# ---------------------------------------------------------------------------
# Differentiable primitives
# ---------------------------------------------------------------------------
# The closed forms are plain tensor programs, so they are also the
# differentiable substrate the optimizer runs gradient descent on.
# ``config_phase_kernel`` accepts arbitrary continuous buswidth/clock values
# and a *fractional* compression in [0, 1] (exact at the {0, 1} endpoints:
# ``1 + (r − 1) == r`` exactly for ``compression_ratio ∈ [0.5, 2]``);
# ``onoff_n_smooth`` / ``idlewait_n_smooth`` are the pre-floor item counts.
def config_phase_kernel(dev: Mapping[str, torch.Tensor], w, f, c) -> dict[str, torch.Tensor]:
    """Configuration-phase stage models over broadcast tensors,
    differentiable in ``w`` (buswidth), ``f`` (clock MHz) and ``c``
    (compression: booleans for the exact Table-1 behaviour, floats in
    [0, 1] for the relaxed model)."""
    ref = dev["bitstream_bits"]
    w = torch.as_tensor(w, dtype=_F64, device=ref.device)
    f = torch.as_tensor(f, dtype=_F64, device=ref.device)
    lanes = torch.mul(w, f)
    c = torch.as_tensor(c, device=ref.device)
    cf = c.to(lanes.dtype) if c.dtype == torch.bool else c
    load_bits = dev["bitstream_bits"] * (1.0 + cf * (dev["compression_ratio"] - 1.0))
    load_time = _div(_div(load_bits, lanes), 1000.0)
    k = dev["k_io_mw_per_lane_mhz"] + cf * dev["k_comp_mw_per_lane_mhz"]
    load_power = dev["p_static_load_mw"] + k * lanes
    load_energy = _div(load_power * load_time, 1000.0)
    setup_energy = _div(dev["setup_power_mw"] * dev["setup_time_ms"], 1000.0)
    config_time = dev["setup_time_ms"] + load_time
    config_energy = setup_energy + load_energy
    config_power = _div(1000.0 * config_energy, config_time)
    return {
        "load_time_ms": load_time,
        "load_power_mw": load_power,
        "load_energy_mj": load_energy,
        "config_time_ms": config_time,
        "config_power_mw": config_power,
        "config_energy_mj": config_energy,
    }


def onoff_n_smooth(e_item, budget):
    """Real-valued Eq.-3 count for On-Off: ``budget / e_item`` (no floor)."""
    return _div(budget, e_item)


def idlewait_n_smooth(e_init, e_exec, e_idle, budget):
    """Real-valued Eq.-3 count for Idle-Waiting (no floor), clamped at 0."""
    return torch.clamp_min(_div(budget - e_init + e_idle, e_exec + e_idle), 0.0)


#: :func:`repro_torch.core.energy_model.idle_energy_mj` as a tensor program:
#: ``p_idle · (t_req − t_exec) / 1000``.
idle_energy_kernel = _idle_energy

#: :func:`repro_torch.core.energy_model.crossover_period_ms` as a tensor
#: program (∞ where ``p_idle ≤ 0``).
crossover_kernel = _crossover


# ---------------------------------------------------------------------------
# Public batch API: strategy evaluation over broadcastable tensors
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchStrategyResult:
    """Tensor counterpart of :class:`~repro_torch.core.energy_model.StrategyResult`.

    All fields broadcast to one common shape on the run's device; ``n_max``
    is int64 and exactly equal to the scalar path's, ``feasible`` is bool.
    """

    strategy: str
    request_period_ms: torch.Tensor
    n_max: torch.Tensor
    lifetime_ms: torch.Tensor
    energy_per_item_mj: torch.Tensor
    feasible: torch.Tensor

    @property
    def lifetime_hours(self) -> torch.Tensor:
        return _div(self.lifetime_ms, 3_600_000.0)


def _onoff_kernel(e_total, t_total, t_req, budget, powerup):
    e_item = e_total + powerup      # onoff_item_energy_mj
    feasible = t_req >= t_total
    n = torch.where(feasible, _onoff_n_max(e_item, budget), 0)
    t_req_b, n = torch.broadcast_tensors(t_req + 0.0 * budget, n)
    return {
        "n_max": n,
        "lifetime_ms": n * t_req_b,
        "energy_per_item_mj": e_item.expand(n.shape),
        "feasible": feasible.expand(n.shape),
        "request_period_ms": t_req_b,
    }


def _idlewait_kernel(e_config, e_exec, t_exec, t_req, budget, p_idle, powerup):
    feasible = t_req >= t_exec
    # guard the infeasible lanes: the scalar path never evaluates idle energy there
    t_safe = torch.where(feasible, t_req, t_exec)
    e_idle = _idle_energy(p_idle, t_safe, t_exec)
    e_init = e_config + powerup                     # idlewait_init_energy_mj
    n = torch.where(feasible, _idlewait_n_max(e_init, e_exec, e_idle, budget), 0)
    marginal = e_exec + torch.where(feasible, e_idle, 0.0)
    t_req_b, n, marginal = torch.broadcast_tensors(t_req + 0.0 * budget + 0.0 * p_idle, n, marginal)
    return {
        "n_max": n,
        "lifetime_ms": n * t_req_b,
        "energy_per_item_mj": marginal,
        "feasible": feasible.expand(n.shape),
        "request_period_ms": t_req_b,
    }


def evaluate_onoff_batch(
    item: WorkloadItem,
    request_periods_ms,
    e_budgets_mj=em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> BatchStrategyResult:
    """Vectorized :func:`repro_torch.core.energy_model.evaluate_onoff`.

    ``request_periods_ms`` and ``e_budgets_mj`` are broadcast together (pass
    pre-shaped tensors, e.g. from :func:`grid_axes`, for outer products).
    """
    device = resolve_device(device)
    it = ItemArrays.from_item(item, device)
    out = _onoff_kernel(
        it.e_total_mj, it.t_total_ms, _arr(request_periods_ms, device),
        _arr(e_budgets_mj, device), _arr(powerup_overhead_mj, device),
    )
    return BatchStrategyResult(strategy="on_off", **out)


def evaluate_idlewait_batch(
    item: WorkloadItem,
    request_periods_ms,
    e_budgets_mj=em.PAPER_ENERGY_BUDGET_MJ,
    idle_powers_mw=None,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> BatchStrategyResult:
    """Vectorized :func:`repro_torch.core.energy_model.evaluate_idlewait`."""
    device = resolve_device(device)
    it = ItemArrays.from_item(item, device)
    p_idle = it.idle_power_mw if idle_powers_mw is None else _arr(idle_powers_mw, device)
    out = _idlewait_kernel(
        it.e_config_mj, it.e_exec_mj, it.t_exec_ms, _arr(request_periods_ms, device),
        _arr(e_budgets_mj, device), p_idle, _arr(powerup_overhead_mj, device),
    )
    return BatchStrategyResult(strategy="idle_waiting", **out)


def crossover_batch(
    item: WorkloadItem,
    idle_powers_mw=None,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> torch.Tensor:
    """Vectorized :func:`repro_torch.core.energy_model.crossover_period_ms`
    over a tensor of idle powers."""
    device = resolve_device(device)
    it = ItemArrays.from_item(item, device)
    p_idle = it.idle_power_mw if idle_powers_mw is None else _arr(idle_powers_mw, device)
    e_onoff = it.e_total_mj + _arr(powerup_overhead_mj, device)
    return _crossover(e_onoff, it.e_exec_mj, it.t_exec_ms, p_idle)


def evaluate_adaptive_batch(
    item: WorkloadItem,
    request_periods_ms,
    e_budgets_mj=em.PAPER_ENERGY_BUDGET_MJ,
    idle_powers_mw=None,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> BatchStrategyResult:
    """Vectorized :meth:`repro_torch.core.adaptive.AdaptiveStrategy.evaluate`:
    the pure-threshold rule ``T_req ≤ T_cross → Idle-Waiting else On-Off``,
    selecting the winning static's tensors element-wise."""
    oo = evaluate_onoff_batch(item, request_periods_ms, e_budgets_mj, powerup_overhead_mj, device)
    iw = evaluate_idlewait_batch(
        item, request_periods_ms, e_budgets_mj, idle_powers_mw, powerup_overhead_mj, device
    )
    cross = crossover_batch(item, idle_powers_mw, powerup_overhead_mj, device)
    pick_iw = torch.broadcast_tensors(iw.request_period_ms <= cross, iw.n_max)[0]

    def sel(a, b):
        return torch.where(pick_iw, a, b)

    return BatchStrategyResult(
        strategy="adaptive",
        request_period_ms=iw.request_period_ms,
        n_max=sel(iw.n_max, oo.n_max),
        lifetime_ms=sel(iw.lifetime_ms, oo.lifetime_ms),
        energy_per_item_mj=sel(iw.energy_per_item_mj, oo.energy_per_item_mj),
        feasible=sel(iw.feasible, oo.feasible),
    )


# ---------------------------------------------------------------------------
# Configuration-phase grid (Exp. 1, vectorized)
# ---------------------------------------------------------------------------
def _broadcast_dict(out: dict) -> dict[str, torch.Tensor]:
    shape = torch.broadcast_shapes(*(v.shape for v in out.values()))
    return {k: v.expand(shape) for k, v in out.items()}


def config_phase_grid(
    devices: Sequence[FpgaDevice] | FpgaDevice,
    buswidths: Sequence[int] = SPI_BUSWIDTHS,
    clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
    compression: Sequence[bool] = COMPRESSION_OPTIONS,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Vectorized :func:`repro_torch.core.config_phase.sweep_config_space`.

    Returns a dict of tensors with shape ``(D, W, F, C)`` — device,
    buswidth, clock, compression — matching every ``SweepPoint`` field.
    Arbitrary (off-Table-1) clock/buswidth values are accepted: the
    closed-form model is defined on the continuum.
    """
    if isinstance(devices, FpgaDevice):
        devices = (devices,)
    _validate_grid_axis("buswidths", buswidths, caller="config_phase_grid")
    _validate_grid_axis("clocks_mhz", clocks_mhz, caller="config_phase_grid")
    _validate_grid_axis("compression", compression, caller="config_phase_grid")
    device = resolve_device(device)
    dev = DeviceArrays.from_devices(devices, device).reshape((len(devices), 1, 1, 1))
    w, f, c = grid_axes(buswidths, clocks_mhz, [1.0 * bool(x) for x in compression], device=device)
    w, f, c = w[None], f[None], c[None].to(torch.bool)   # prepend the device axis
    return _broadcast_dict(_config_grid_kernel(dev.cols(), w, f, c))


# ---------------------------------------------------------------------------
# The full 7-axis design-space sweep
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepGrid:
    """Declarative description of a design-space grid (see module docstring
    for the axis layout).  ``base_item`` supplies the execution phases and
    the baseline idle power; the configuration phase is *derived* per grid
    point from the device model, exactly as the paper derives Table 2's
    configuration row from Experiment 1's optimum."""

    devices: tuple[FpgaDevice, ...] = (SPARTAN7_XC7S15,)
    buswidths: tuple[int, ...] = SPI_BUSWIDTHS
    clocks_mhz: tuple[float, ...] = SPI_CLOCKS_MHZ
    compression: tuple[bool, ...] = COMPRESSION_OPTIONS
    request_periods_ms: tuple[float, ...] = (40.0,)
    idle_methods: tuple[IdlePowerMethod, ...] = (IdlePowerMethod.BASELINE,)
    e_budgets_mj: tuple[float, ...] = (em.PAPER_ENERGY_BUDGET_MJ,)
    base_item: WorkloadItem | None = None
    powerup_overhead_mj: float = 0.0

    def __post_init__(self) -> None:
        # same contract as the scalar sweeps: no silent empty grids, no
        # shuffled axes — GridResult.to_records maps flat indices back by
        # axis order.
        for name, vals in (
            ("buswidths", self.buswidths),
            ("clocks_mhz", self.clocks_mhz),
            ("request_periods_ms", self.request_periods_ms),
            ("e_budgets_mj", self.e_budgets_mj),
        ):
            _validate_grid_axis(name, vals, caller="SweepGrid")
        for name, vals in (
            ("devices", self.devices),
            ("compression", self.compression),
            ("idle_methods", self.idle_methods),
        ):
            _validate_grid_axis(name, vals, sorted_required=False, caller="SweepGrid")

    @property
    def shape(self) -> tuple[int, ...]:
        return (
            len(self.devices),
            len(self.buswidths),
            len(self.clocks_mhz),
            len(self.compression),
            len(self.request_periods_ms),
            len(self.idle_methods),
            len(self.e_budgets_mj),
        )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def item(self) -> WorkloadItem:
        return self.base_item if self.base_item is not None else paper_lstm_item()

    def idle_powers_mw(self) -> list[float]:
        item = self.item()
        return [
            item.idle_power_mw if m is IdlePowerMethod.BASELINE else IDLE_POWER_MW[m]
            for m in self.idle_methods
        ]

    def axis_labels(self) -> dict[str, list]:
        return {
            "device": [d.name for d in self.devices],
            "buswidth": list(self.buswidths),
            "clock_mhz": list(self.clocks_mhz),
            "compression": [bool(c) for c in self.compression],
            "request_period_ms": list(self.request_periods_ms),
            "idle_method": [m.value for m in self.idle_methods],
            "e_budget_mj": list(self.e_budgets_mj),
        }


#: Names of the quantity tensors a full sweep produces.
GRID_QUANTITIES = (
    "config_time_ms",
    "config_energy_mj",
    "onoff_n_max",
    "onoff_lifetime_ms",
    "onoff_energy_per_item_mj",
    "onoff_feasible",
    "iw_n_max",
    "iw_lifetime_ms",
    "iw_energy_per_item_mj",
    "iw_feasible",
    "crossover_ms",
    "adaptive_n_max",
    "adaptive_lifetime_ms",
    "adaptive_picks_iw",
)


@dataclasses.dataclass(frozen=True)
class GridResult:
    """Dense result tensors (each of ``grid.shape``, on the run's device)
    plus the axes that index them.  ``arrays`` keys are
    :data:`GRID_QUANTITIES`."""

    grid: SweepGrid
    arrays: Mapping[str, torch.Tensor]

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.arrays[key]

    def records_at(self, flat_indices) -> list[dict]:
        """One dict per given flat (C-order) grid index: the axis labels,
        then every quantity as a Python scalar."""
        labels = self.grid.axis_labels()
        names = list(labels)
        flat_indices = np.asarray(flat_indices, dtype=np.int64)
        axes = np.unravel_index(flat_indices, self.grid.shape)
        idx = np.stack(axes, axis=1)
        cols = {}
        for k, v in self.arrays.items():
            # gather through the broadcast view: no grid-sized copy
            sel = tuple(torch.as_tensor(a, device=v.device) for a in axes)
            cols[k] = v.expand(self.grid.shape)[sel].cpu().numpy()
        out = []
        for j in range(len(flat_indices)):
            rec = {name: labels[name][idx[j][i]] for i, name in enumerate(names)}
            for k, v in cols.items():
                rec[k] = v[j].item()
            out.append(rec)
        return out

    def to_records(self, limit: int | None = None) -> list[dict]:
        """Flatten to one dict per grid point (C-order over the 7 axes).
        ``limit`` caps the record count for JSON emission."""
        n = self.grid.size if limit is None else min(limit, self.grid.size)
        return self.records_at(np.arange(n))

    def to_json_dict(self, limit: int | None = None) -> dict:
        return {
            "shape": list(self.grid.shape),
            "size": self.grid.size,
            "axes": self.grid.axis_labels(),
            "powerup_overhead_mj": self.grid.powerup_overhead_mj,
            "item": self.grid.item().to_dict(),
            "records": self.to_records(limit),
        }


def _sweep_kernel(dev_cols, w, f, c, t_req, p_idle, budget,
                  exec_energies, exec_times, e_exec, t_exec, powerup):
    cfg = _config_grid_kernel(dev_cols, w, f, c)
    t_config = cfg["config_time_ms"]

    # The scalar pipeline derives the per-item configuration phase with
    # FpgaDevice.config_phase(): energy round-trips through the phase's
    # *average power* (E → P=1000·E/T → P·T/1000), and item totals are the
    # built-in sum() over phases.  Reproduce both so grid points are
    # bit-identical to scalar evaluation of the constructed WorkloadItem.
    # (The reference folds the phases left to right, which equals sum()
    # only before Python 3.12; see _py_sum.)
    e_config = _div(cfg["config_power_mw"] * t_config, 1000.0)
    e_total = _py_sum([e_config, *(e_p.expand(e_config.shape) for e_p in exec_energies)])
    t_total = _py_sum([t_config, *(t_p.expand(t_config.shape) for t_p in exec_times)])

    e_onoff = e_total + powerup
    oo_feasible = t_req >= t_total
    oo_n = torch.where(oo_feasible, _onoff_n_max(e_onoff, budget), 0)

    iw_feasible = t_req >= t_exec
    t_safe = torch.where(iw_feasible, t_req, t_exec)
    e_idle = _idle_energy(p_idle, t_safe, t_exec)
    e_init = e_config + powerup
    iw_n = torch.where(iw_feasible, _idlewait_n_max(e_init, e_exec, e_idle, budget), 0)

    cross = _crossover(e_onoff, e_exec, t_exec, p_idle)
    pick_iw = t_req <= cross
    adaptive_n = torch.where(pick_iw, iw_n, oo_n)

    out = {
        "config_time_ms": t_config,
        "config_energy_mj": cfg["config_energy_mj"],
        "onoff_n_max": oo_n,
        "onoff_lifetime_ms": oo_n * t_req,
        "onoff_energy_per_item_mj": e_onoff,
        "onoff_feasible": oo_feasible,
        "iw_n_max": iw_n,
        "iw_lifetime_ms": iw_n * t_req,
        "iw_energy_per_item_mj": e_exec + torch.where(iw_feasible, e_idle, 0.0),
        "iw_feasible": iw_feasible,
        "crossover_ms": cross,
        "adaptive_n_max": adaptive_n,
        "adaptive_lifetime_ms": adaptive_n * t_req,
        "adaptive_picks_iw": pick_iw,
    }
    return _broadcast_dict(out)


def sweep_batch(grid: SweepGrid, device="cuda") -> GridResult:
    """Evaluate every quantity of :data:`GRID_QUANTITIES` over the full grid
    in one vectorized float64 call on ``device``.

    Scalar-oracle equivalence: grid point ``(d, w, f, c, t, m, b)`` equals
    building the workload item whose configuration phase is
    ``devices[d].config_phase(ConfigParams(w, f, c))`` and evaluating the
    scalar strategies at period ``t``, idle method ``m``, budget ``b``.
    The result's tensors are broadcast views of the smaller quantities, so
    a grid costs one output-sized buffer per quantity that varies over it.
    """
    item = grid.item()
    if not item.has_phase(CONFIGURATION):
        raise ValueError(
            "sweep_batch derives the configuration phase from the device model; "
            f"base_item {item.name!r} must carry a configuration phase to replace"
        )
    device = resolve_device(device)
    nd = len(grid.shape)
    dev = DeviceArrays.from_devices(grid.devices, device).reshape(
        (len(grid.devices),) + (1,) * (nd - 1)
    )
    _, w, f, c, t_req, p_idle, budget = grid_axes(
        [0.0] * len(grid.devices),          # placeholder: device handled above
        grid.buswidths,
        grid.clocks_mhz,
        [1.0 * bool(x) for x in grid.compression],
        grid.request_periods_ms,
        grid.idle_powers_mw(),
        grid.e_budgets_mj,
        device=device,
    )
    it = ItemArrays.from_item(item, device)
    exec_phases = [p for p in item.phases if p.name != CONFIGURATION]
    out = _sweep_kernel(
        dev.cols(), w, f, c.to(torch.bool), t_req, p_idle, budget,
        tuple(_arr(p.energy_mj, device) for p in exec_phases),
        tuple(_arr(p.time_ms, device) for p in exec_phases),
        it.e_exec_mj, it.t_exec_ms, _arr(grid.powerup_overhead_mj, device),
    )
    return GridResult(grid=grid, arrays=out)
