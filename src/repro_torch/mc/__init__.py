"""Monte Carlo uncertainty quantification for every headline number (port
of ``repro.mc``).

The deterministic layers of this repo answer "what is the crossover /
lifetime / energy-per-request?"; this package answers "±what?".  Three
modules:

* :mod:`repro_torch.mc.ensemble`    — S-seed × N-device stochastic fleet
  replications in one tick loop over an ``(S, N)`` carry (reusing the fleet
  substrate and the batched arrival samplers), with Welford streaming
  moments so 10k-seed ensembles run in constant memory;
* :mod:`repro_torch.mc.intervals`   — normal, bootstrap, percentile, and
  streaming-moment confidence intervals;
* :mod:`repro_torch.mc.sensitivity` — delta-method error propagation
  through the differentiable closed-form primitives (torch autograd),
  cross-validated against the empirical MC bands.

CLI: ``python -m repro_torch.launch.mc`` → ``BENCH_mc.json`` (CI-banded
paper numbers; at zero jitter the bands collapse onto 499.06 ms and 12.39×
exactly).
"""
from repro_torch.mc.ensemble import (
    PeriodicEnsembleResult,
    RoutedEnsembleResult,
    Welford,
    periodic_ensemble,
    routed_ensemble,
    run_periodic_ensemble,
    run_routed_ensemble,
)
from repro_torch.mc.intervals import (
    ConfidenceInterval,
    bootstrap_interval,
    ci_dict,
    normal_interval,
    percentile_interval,
    welford_interval,
    z_value,
)
from repro_torch.mc.sensitivity import (
    config_energy_uncertainty,
    cross_validate,
    crossover_uncertainty,
    delta_method,
    energy_per_request_uncertainty,
    jittered_params,
    lifetime_ratio_uncertainty,
)

__all__ = [
    "Welford",
    "PeriodicEnsembleResult",
    "RoutedEnsembleResult",
    "periodic_ensemble",
    "run_periodic_ensemble",
    "routed_ensemble",
    "run_routed_ensemble",
    "ConfidenceInterval",
    "z_value",
    "normal_interval",
    "bootstrap_interval",
    "percentile_interval",
    "welford_interval",
    "ci_dict",
    "jittered_params",
    "delta_method",
    "cross_validate",
    "crossover_uncertainty",
    "lifetime_ratio_uncertainty",
    "energy_per_request_uncertainty",
    "config_energy_uncertainty",
]
