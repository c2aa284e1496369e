"""The paper's contribution, ported (a copy of the pure-Python part of
``repro.core``):

- phases         : power/time phase model of a workload item (Table 2)
- config_phase   : FPGA configuration-phase model + parameter sweep (Exp. 1)
- energy_model   : analytical model, Eqs. 1-4 (§4.3)
- strategies     : On-Off vs Idle-Waiting + power-saving methods (Exp. 2-3)
- workload       : YAML workload/item descriptions (§5.1)
- simulator      : discrete-event duty-cycle simulator (§5.1) + trace replay
- arrivals       : request-arrival processes (deterministic/jittered/Poisson/
                   MMPP/diurnal/flash-crowd/trace), their scalar streams
- adaptive       : adaptive power policy (crossover decision rule + online
                   controller with hysteresis-guarded ski-rental hybrid)
- tpu_energy     : TPU-pod adaptation of the phase/energy model
- planner        : deployment planner, the analytical model inverted
- duty_cycle     : runnable duty-cycle controller for the serving engine
- batch_eval     : vectorized (torch) batch sweep engine — whole design
                   grids per call on the card, bit-exact vs the scalar
                   closed forms
- pareto         : Pareto frontiers + crossover surfaces over batch grids

``arrivals`` also samples one stream per device in a batch
(``sample_batch``, from a ``torch.Generator``).
"""
from repro_torch.core.phases import (
    CONFIGURATION,
    DATA_LOADING,
    DATA_OFFLOADING,
    EXECUTION_PHASES,
    IDLE,
    INFERENCE,
    PAPER_IDLE_POWER_BASELINE_MW,
    Phase,
    WorkloadItem,
    paper_lstm_item,
)
from repro_torch.core.config_phase import (
    BEST_PARAMS,
    COMPRESSION_OPTIONS,
    DEVICES,
    SPARTAN7_XC7S15,
    SPARTAN7_XC7S25,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    WORST_PARAMS,
    ConfigParams,
    FpgaDevice,
    energy_reduction_factor,
    optimal_params,
    sweep_config_space,
    time_reduction_factor,
)
from repro_torch.core.energy_model import (
    CALIBRATED_POWERUP_OVERHEAD_MJ,
    PAPER_ENERGY_BUDGET_MJ,
    StrategyResult,
    crossover_period_ms,
    evaluate_idlewait,
    evaluate_onoff,
    idle_energy_mj,
    idlewait_cumulative_energy_mj,
    idlewait_n_max,
    onoff_cumulative_energy_mj,
    onoff_n_max,
)
from repro_torch.core.strategies import (
    FLASH_POWER_MW,
    IDLE_POWER_MW,
    IdlePowerMethod,
    IdleWaitingStrategy,
    OnOffStrategy,
    Strategy,
    compare_strategies,
    idle_power_saving_pct,
)
from repro_torch.core.workload import (
    PAPER_WORKLOAD,
    ExperimentSpec,
    WorkloadSpec,
    paper_experiment,
)
from repro_torch.core.simulator import (
    SimEvent,
    SimResult,
    TraceSimResult,
    simulate,
    simulate_trace,
)
from repro_torch.core.arrivals import (
    ArrivalProcess,
    DeterministicArrivals,
    MMPPArrivals,
    PoissonArrivals,
    TraceArrivals,
    make_process,
)
from repro_torch.core.adaptive import (
    AdaptiveStrategy,
    PolicyController,
    StaticPolicy,
    break_even_timeout_ms,
)

from repro_torch.core import batch_eval, pareto, tpu_energy  # noqa: E402  (after the scalar core they build on)

__all__ = [k for k in dir() if not k.startswith("_")]
