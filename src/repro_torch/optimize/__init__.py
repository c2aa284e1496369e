"""Configuration-and-policy optimization: choose strategies, don't just
evaluate them (port of ``repro.optimize``).

The rest of the port answers "what does configuration X cost?"
(:mod:`repro_torch.core`), "what does a whole grid of X cost?"
(:mod:`repro_torch.core.batch_eval`) and "what does a fleet of X do?"
(:mod:`repro_torch.fleet`).  This package closes the loop:

* :mod:`repro_torch.optimize.relax`   — smooth, differentiable relaxation
  of the energy/lifetime closed forms (continuous clock, softmax over
  discrete bus-width/compression, sigmoid feasibility/crossover gates);
* :mod:`repro_torch.optimize.descent` — batched multi-start Adam over the
  relaxation (float64 autograd on the card), rounded back to the legal
  grid and always re-validated against the exact
  :mod:`repro_torch.core.batch_eval` oracle;
* :mod:`repro_torch.optimize.planner` — fleet-wide budget allocation over
  the affine Eq. 1–2 closed forms (host numpy), replayable bit-for-bit
  through :func:`repro_torch.fleet.step.run_periodic`.
"""
from repro_torch.optimize.descent import (
    DescentSettings,
    OptimizeResult,
    descend,
    optimize_config,
    optimize_lifetime,
    trace_config_frontier,
)
from repro_torch.optimize.planner import (
    BudgetAllocation,
    plan_budgets,
    replay_allocation,
)
from repro_torch.optimize.relax import (
    RelaxedProblem,
    config_energy_loss,
    lifetime_loss,
    relaxed_config,
    relaxed_counts,
    snap,
    straight_through_onehot,
    straight_through_round,
)

__all__ = [
    "BudgetAllocation",
    "DescentSettings",
    "OptimizeResult",
    "RelaxedProblem",
    "config_energy_loss",
    "descend",
    "lifetime_loss",
    "optimize_config",
    "optimize_lifetime",
    "plan_budgets",
    "relaxed_config",
    "relaxed_counts",
    "replay_allocation",
    "snap",
    "straight_through_onehot",
    "straight_through_round",
    "trace_config_frontier",
]
