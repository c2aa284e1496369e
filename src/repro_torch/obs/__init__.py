"""Phase-resolved observability: energy ledger, traces, metrics, reports
(port of ``repro.obs``).

Four pieces, one contract:

* :mod:`repro_torch.obs.ledger` — :class:`EnergyLedger`, the five-axis
  (configure / compute / idle / off / overhead) energy breakdown every
  simulation path reports, with a 1e-9-relative conservation guarantee
  against the path's own total.
* :mod:`repro_torch.obs.trace` — :class:`TraceRecorder` structured state-
  transition events, exportable as Chrome-trace / Perfetto JSON.
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`
  counters/gauges/histograms plus the in-loop accumulation idiom on the
  card (:func:`scan_histogram`).
* :mod:`repro_torch.obs.report` — fuses all three into JSON/markdown run
  reports (:mod:`repro_torch.launch.obs` is the CLI).

:func:`~repro_torch.obs.ledger.ledger_from_rollout` gives a learned-policy
rollout (:mod:`repro_torch.policy.rollout`) the same breakdown.

>>> from repro_torch.obs import EnergyLedger
>>> led = EnergyLedger.from_axes(configure=11.5, compute=2.25, idle=1.0)
>>> led.total_mj
14.75
>>> led.assert_conserves(14.75)
0.0
"""
from repro_torch.obs.ledger import (
    AXES,
    PHASE_TO_AXIS,
    EnergyLedger,
    axis_of_phase,
    ledger_from_rollout,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_edges_ms,
    fleet_queue_depth_edges,
    hist_update,
    routed_metrics,
    scan_histogram,
)
from repro_torch.obs.report import render_markdown, run_report, trace_summary, write_report
from repro_torch.obs.trace import (
    TraceEvent,
    TraceRecorder,
    routed_timeline,
    validate_chrome_trace,
)

__all__ = [
    "AXES",
    "PHASE_TO_AXIS",
    "EnergyLedger",
    "axis_of_phase",
    "ledger_from_rollout",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_latency_edges_ms",
    "fleet_queue_depth_edges",
    "hist_update",
    "routed_metrics",
    "scan_histogram",
    "TraceEvent",
    "TraceRecorder",
    "routed_timeline",
    "validate_chrome_trace",
    "render_markdown",
    "run_report",
    "trace_summary",
    "write_report",
]
