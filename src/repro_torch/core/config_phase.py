"""FPGA configuration-phase model and parameter optimization (paper §4.1,
Exp. 1); a copy of ``repro.core.config_phase`` for the port.

The configuration phase of a 7-series FPGA consists of (Fig. 4):

    Setup  →  Clear Configuration Memory  →  Load Configuration Data  →  Startup

The paper finds Setup is a fixed, model-dependent floor (27 ms @ ~288 mW for
the Spartan-7 XC7S15) and Load Configuration Data ("bitstream loading") is
tunable via three parameters (Table 1):

    SPI buswidth            ∈ {1, 2, 4}
    SPI clock frequency     ∈ {3, 6, 9, 12, 16, 22, 26, 33, 40, 50, 66} MHz
    bitstream compression   ∈ {False, True}

Model (calibrated to the paper's measured anchors — see DESIGN.md §2):

    T_load(w, f, c)  = bits(c) / (w · f)                      [ms, f in MHz→bit/µs]
    P_load(w, f, c)  = p_static + (k_io + c·k_comp) · w · f   [mW]
    E_config         = P_setup·T_setup + P_load·T_load        [mJ]

The static-power term dominates at slow settings, which is exactly why the
paper finds faster loading saves energy: shortening the duration of static
draw beats the extra switching power of wide/fast/compressed transfers.

Calibration anchors reproduced by this model (validated in
tests/test_config_phase.py):

    worst  (single, 3 MHz, no compression):  T=1496.6 ms, E=475.56 mJ
    best   (quad,  66 MHz, compression):     T=36.145 ms, E=11.85 mJ
    ratio:                                   41.4× time, 40.13× energy
    XC7S25 best:                             T=38.09 ms,  E=13.75 mJ
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

from repro_torch.core.phases import CONFIGURATION, Phase, energy_mj

# Parameter space (Table 1).
SPI_BUSWIDTHS: tuple[int, ...] = (1, 2, 4)
SPI_CLOCKS_MHZ: tuple[float, ...] = (3, 6, 9, 12, 16, 22, 26, 33, 40, 50, 66)
COMPRESSION_OPTIONS: tuple[bool, ...] = (False, True)


@dataclasses.dataclass(frozen=True)
class ConfigParams:
    """One point in the bitstream-loading parameter space."""

    buswidth: int = 1
    clock_mhz: float = 3.0
    compression: bool = False

    def __post_init__(self) -> None:
        if self.buswidth not in SPI_BUSWIDTHS:
            raise ValueError(f"buswidth must be one of {SPI_BUSWIDTHS}, got {self.buswidth}")
        if self.clock_mhz not in SPI_CLOCKS_MHZ:
            raise ValueError(f"clock_mhz must be one of {SPI_CLOCKS_MHZ}, got {self.clock_mhz}")

    @property
    def lanes_mhz(self) -> float:
        """Aggregate transfer rate in Mbit/s (= bit/µs)."""
        return self.buswidth * self.clock_mhz


WORST_PARAMS = ConfigParams(buswidth=1, clock_mhz=3, compression=False)
BEST_PARAMS = ConfigParams(buswidth=4, clock_mhz=66, compression=True)


@dataclasses.dataclass(frozen=True)
class FpgaDevice:
    """Per-device configuration-engine model, calibrated from measurements.

    ``bitstream_bits`` is the *effective* transferred bitstream size at the
    paper's measurement conditions (the paper used an LSTM accelerator
    design [13]; 7-series compression elides unused frames, so the effective
    size is design-dependent, not the full device bitstream).
    """

    name: str
    bitstream_bits: float          # raw (uncompressed) transferred bits
    compression_ratio: float       # compressed_bits / raw_bits (< 1)
    setup_time_ms: float           # fixed Setup stage duration
    setup_power_mw: float          # Setup stage power
    p_static_load_mw: float        # static board power during loading
    k_io_mw_per_lane_mhz: float    # IO switching power per (lane · MHz)
    k_comp_mw_per_lane_mhz: float  # extra switching power w/ compression

    # ---- stage models ---------------------------------------------------
    def load_bits(self, params: ConfigParams) -> float:
        return self.bitstream_bits * (self.compression_ratio if params.compression else 1.0)

    def load_time_ms(self, params: ConfigParams) -> float:
        # bits / (Mbit/s) = µs ; /1000 → ms.  lanes_mhz is bit/µs.
        return self.load_bits(params) / params.lanes_mhz / 1000.0

    def load_power_mw(self, params: ConfigParams) -> float:
        k = self.k_io_mw_per_lane_mhz + (self.k_comp_mw_per_lane_mhz if params.compression else 0.0)
        return self.p_static_load_mw + k * params.lanes_mhz

    def load_energy_mj(self, params: ConfigParams) -> float:
        return energy_mj(self.load_power_mw(params), self.load_time_ms(params))

    @property
    def setup_energy_mj(self) -> float:
        return energy_mj(self.setup_power_mw, self.setup_time_ms)

    # ---- whole configuration phase --------------------------------------
    def config_time_ms(self, params: ConfigParams) -> float:
        return self.setup_time_ms + self.load_time_ms(params)

    def config_energy_mj(self, params: ConfigParams) -> float:
        return self.setup_energy_mj + self.load_energy_mj(params)

    def config_power_mw(self, params: ConfigParams) -> float:
        """Average power over the whole configuration phase (what Table 2 lists)."""
        return 1000.0 * self.config_energy_mj(params) / self.config_time_ms(params)

    def config_phase(self, params: ConfigParams) -> Phase:
        """The configuration phase as a :class:`Phase` (power/time pair)."""
        return Phase(CONFIGURATION, self.config_power_mw(params), self.config_time_ms(params))


# ---------------------------------------------------------------------------
# Calibrated devices.  Constants derived in DESIGN.md §2 from the paper's
# measured anchors (Exp. 1); see tests/test_config_phase.py for the asserted
# reproduction of every anchor.
# ---------------------------------------------------------------------------
SPARTAN7_XC7S15 = FpgaDevice(
    name="spartan7-xc7s15",
    bitstream_bits=4_408_830.0,       # 1469.61 ms · 3 Mbit/s  (worst-case anchor)
    compression_ratio=0.547601,       # 9.145 ms · 264 Mbit/s / raw  (best-case anchor)
    setup_time_ms=27.0,
    setup_power_mw=288.0,
    p_static_load_mw=317.405,
    k_io_mw_per_lane_mhz=0.30,
    k_comp_mw_per_lane_mhz=0.186383,
)

SPARTAN7_XC7S25 = FpgaDevice(
    name="spartan7-xc7s25",
    bitstream_bits=5_346_435.0,       # 11.09 ms · 264 Mbit/s / ratio (38.09 ms anchor)
    compression_ratio=0.547601,
    setup_time_ms=27.0,
    setup_power_mw=288.0,
    p_static_load_mw=410.28,          # larger die → more static draw (13.75 mJ anchor)
    k_io_mw_per_lane_mhz=0.30,
    k_comp_mw_per_lane_mhz=0.186383,
)

DEVICES = {d.name: d for d in (SPARTAN7_XC7S15, SPARTAN7_XC7S25)}


# ---------------------------------------------------------------------------
# Parameter sweep (Experiment 1).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SweepPoint:
    params: ConfigParams
    config_time_ms: float
    config_power_mw: float
    config_energy_mj: float
    load_time_ms: float
    load_power_mw: float
    load_energy_mj: float


def _validate_grid_axis(
    name: str,
    values: Sequence,
    sorted_required: bool = True,
    caller: str = "sweep_config_space",
) -> None:
    if len(values) == 0:
        raise ValueError(
            f"{caller}(): {name} is empty — the sweep would be a "
            "silent no-op; pass at least one value"
        )
    vals = list(values)
    if sorted_required and any(b < a for a, b in zip(vals, vals[1:])):
        raise ValueError(
            f"{caller}(): {name} must be sorted ascending "
            f"(got {vals!r}) — downstream consumers index sweep points by "
            "grid order"
        )


def sweep_config_space(
    device: FpgaDevice,
    buswidths: Sequence[int] = SPI_BUSWIDTHS,
    clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
    compression: Sequence[bool] = COMPRESSION_OPTIONS,
) -> list[SweepPoint]:
    """Exhaustive sweep of the configuration parameter space (66 points).

    Axes must be non-empty and sorted ascending (``ValueError`` otherwise):
    callers index the returned list by ``itertools.product`` grid order, so
    an empty or shuffled axis silently corrupts that mapping.
    """
    _validate_grid_axis("buswidths", buswidths)
    _validate_grid_axis("clocks_mhz", clocks_mhz)
    _validate_grid_axis("compression", compression)
    out = []
    for w, f, c in itertools.product(buswidths, clocks_mhz, compression):
        p = ConfigParams(w, f, c)
        out.append(
            SweepPoint(
                params=p,
                config_time_ms=device.config_time_ms(p),
                config_power_mw=device.config_power_mw(p),
                config_energy_mj=device.config_energy_mj(p),
                load_time_ms=device.load_time_ms(p),
                load_power_mw=device.load_power_mw(p),
                load_energy_mj=device.load_energy_mj(p),
            )
        )
    return out


def optimal_params(device: FpgaDevice, metric: str = "energy") -> SweepPoint:
    """The sweep point minimizing ``metric`` ∈ {'energy', 'time'}."""
    key = {
        "energy": lambda s: s.config_energy_mj,
        "time": lambda s: s.config_time_ms,
    }[metric]
    return min(sweep_config_space(device), key=key)


def energy_reduction_factor(device: FpgaDevice) -> float:
    """Worst-case / best-case configuration energy (paper: 40.13×)."""
    pts = sweep_config_space(device)
    energies = [s.config_energy_mj for s in pts]
    return max(energies) / min(energies)


def time_reduction_factor(device: FpgaDevice) -> float:
    """Worst-case / best-case configuration time (paper: 41.4×)."""
    pts = sweep_config_space(device)
    times = [s.config_time_ms for s in pts]
    return max(times) / min(times)
