"""Roofline-calibrated per-model request costs (port of ``repro.costs``).

Per-model, per-batch-size inference energy/latency of the model zoo
(`repro_torch.configs`) become :class:`repro_torch.core.phases.WorkloadItem`
phases, so heterogeneous fleets of *actual models* run through
``fleet.run_periodic``/``run_routed`` and the MC ensembles without any of
those layers changing.

Three layers:

* :mod:`repro_torch.costs.counts` — closed-form FLOPs/bytes per module
  (attention / SSD / LSTM / dequant / FFN) and per request, in the
  reference's conventions;
* :mod:`repro_torch.costs.calibrate` — accelerator profiles + roofline
  latency and phase energies, with measured-kernel efficiency calibration;
* :mod:`repro_torch.costs.zoo` — the registry: ``model_request_cost`` /
  ``model_device_spec`` / ``model_mix_fleet``, with the paper's LSTM as
  the bit-exact zero-calibration limit.

CLI: ``python -m repro_torch.launch.costs`` → ``BENCH_costs.json``.
"""
from repro_torch.costs.calibrate import (
    DEFAULT_EFFICIENCY,
    EDGE_ACCEL,
    PROFILES,
    TPU_V5E_LIKE,
    AcceleratorProfile,
    measured_efficiency,
    request_item,
    roofline_time_ms,
)
from repro_torch.costs.counts import (
    OpCounts,
    RequestCounts,
    attention_counts,
    dequant_counts,
    ffn_counts,
    layer_counts,
    lstm_counts,
    matmul_counts,
    request_counts,
    ssd_counts,
)
from repro_torch.costs.zoo import (
    PAPER_LSTM_MODEL,
    RequestCost,
    default_profile,
    model_device_spec,
    model_mix_fleet,
    model_names,
    model_request_cost,
    model_workload_item,
)

__all__ = [
    "AcceleratorProfile",
    "DEFAULT_EFFICIENCY",
    "EDGE_ACCEL",
    "OpCounts",
    "PAPER_LSTM_MODEL",
    "PROFILES",
    "RequestCost",
    "RequestCounts",
    "TPU_V5E_LIKE",
    "attention_counts",
    "default_profile",
    "dequant_counts",
    "ffn_counts",
    "layer_counts",
    "lstm_counts",
    "matmul_counts",
    "measured_efficiency",
    "model_device_spec",
    "model_mix_fleet",
    "model_names",
    "model_request_cost",
    "model_workload_item",
    "request_counts",
    "request_item",
    "roofline_time_ms",
    "ssd_counts",
]
