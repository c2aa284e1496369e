"""The paper's contribution, ported (a copy of the pure-Python part of
``repro.core``):

- phases         : power/time phase model of a workload item (Table 2)
- config_phase   : FPGA configuration-phase model + parameter sweep (Exp. 1)
- energy_model   : analytical model, Eqs. 1-4 (§4.3)
- strategies     : On-Off vs Idle-Waiting + power-saving methods (Exp. 2-3)
- workload       : YAML workload/item descriptions (§5.1)
- simulator      : discrete-event duty-cycle simulator (§5.1) + trace replay
- adaptive       : adaptive power policy (crossover decision rule + online
                   controller with hysteresis-guarded ski-rental hybrid)
- duty_cycle     : runnable duty-cycle controller for the serving engine

Not ported yet: the arrival processes (``arrivals``), ``batch_eval`` and
``pareto`` (ROADMAP A6), ``planner`` and ``tpu_energy``.
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
from repro_torch.core.adaptive import (
    AdaptiveStrategy,
    PolicyController,
    StaticPolicy,
    break_even_timeout_ms,
)

__all__ = [k for k in dir() if not k.startswith("_")]
