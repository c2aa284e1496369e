"""Run reports: fuse ledger + metrics + trace summary into one artifact
(port of ``repro.obs.report``).

:func:`run_report` assembles the JSON payload the observability CLI
(:mod:`repro_torch.launch.obs`) emits — phase-resolved energy ledger, metrics
registry snapshot, trace statistics, conservation self-check results, and
the provenance manifest — and :func:`render_markdown` renders the same
payload as a human-readable markdown digest for CI job summaries.

Import-cheap: the standard library only, no torch.
"""
from __future__ import annotations

import json
from typing import Mapping, Optional

__all__ = ["run_report", "render_markdown", "write_report", "trace_summary"]


def trace_summary(chrome_payload: Mapping) -> dict:
    """Compact statistics of a Chrome-trace payload (event/track counts)."""
    events = chrome_payload.get("traceEvents", [])
    data = [e for e in events if e.get("ph") != "M"]
    by_ph: dict[str, int] = {}
    names: dict[str, int] = {}
    for e in data:
        by_ph[e["ph"]] = by_ph.get(e["ph"], 0) + 1
        names[e["name"]] = names.get(e["name"], 0) + 1
    ts = [e["ts"] for e in data]
    return {
        "n_events": len(data),
        "n_tracks": len({(e.get("pid"), e.get("tid")) for e in data}),
        "by_phase_type": dict(sorted(by_ph.items())),
        "by_name": dict(sorted(names.items())),
        "span_ms": (max(ts) - min(ts)) / 1000.0 if ts else 0.0,
    }


def run_report(
    *,
    ledger=None,
    metrics=None,
    summary: Optional[Mapping] = None,
    trace: Optional[Mapping] = None,
    conservation: Optional[Mapping] = None,
    throughput: Optional[Mapping] = None,
    config: Optional[Mapping] = None,
    manifest: Optional[Mapping] = None,
) -> dict:
    """Assemble the observability report payload.

    ``ledger`` — an :class:`~repro_torch.obs.ledger.EnergyLedger` (or its
    ``to_dict()``); ``metrics`` — a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` (or its ``to_dict()``);
    ``trace`` — :func:`trace_summary` output; ``conservation`` — the
    self-check results (path → measured relative error); the rest are
    passed through.  ``manifest`` may be omitted — the launcher's ``emit``
    stamps one in.
    """
    report: dict = {"kind": "obs"}
    if config is not None:
        report["config"] = dict(config)
    if ledger is not None:
        report["ledger"] = ledger if isinstance(ledger, Mapping) else ledger.to_dict()
    if conservation is not None:
        report["conservation"] = dict(conservation)
    if metrics is not None:
        report["metrics"] = (
            metrics if isinstance(metrics, Mapping) else metrics.to_dict()
        )
    if summary is not None:
        report["summary"] = dict(summary)
    if trace is not None:
        report["trace"] = dict(trace)
    if throughput is not None:
        report["throughput"] = dict(throughput)
    if manifest is not None:
        report["manifest"] = dict(manifest)
    return report


def _fmt(v, nd: int = 4) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def render_markdown(report: Mapping) -> str:
    """Markdown digest of a :func:`run_report` payload."""
    lines = ["# Observability report", ""]

    manifest = report.get("manifest")
    if manifest:
        sha = manifest.get("git_sha") or "?"
        backend = manifest.get("backend") or "?"
        versions = manifest.get("versions") or {}
        card = manifest.get("card")
        lines += [
            f"- git: `{sha[:12] if isinstance(sha, str) else sha}`"
            f" · device: `{backend}`" + (f" ({card})" if card else "")
            + f" · torch {versions.get('torch', '?')}"
            f" · cuda {versions.get('cuda') or '?'}"
            f" · seed {manifest.get('seed')}"
            f" · {manifest.get('timestamp', '?')}",
            "",
        ]

    ledger = report.get("ledger")
    if ledger:
        lines += ["## Energy ledger", "", "| axis | mJ | share |", "|---|---:|---:|"]
        fracs = ledger.get("fractions", {})
        for axis in ("configure", "compute", "idle", "off", "overhead"):
            key = f"{axis}_mj"
            if key in ledger:
                frac = fracs.get(axis)
                share = f"{100.0 * frac:.2f}%" if frac is not None else "—"
                lines.append(f"| {axis} | {_fmt(ledger[key], 6)} | {share} |")
        lines.append(f"| **total** | **{_fmt(ledger.get('total_mj'), 6)}** | 100% |")
        lines.append("")

    conservation = report.get("conservation")
    if conservation:
        lines += ["## Conservation self-checks", "",
                  "| path | max relative error |", "|---|---:|"]
        for path, err in conservation.items():
            lines.append(f"| {path} | {_fmt(err, 3)} |")
        lines.append("")

    metrics = report.get("metrics")
    if metrics:
        lines += ["## Metrics", "", "| metric | type | value |", "|---|---|---:|"]
        for name, m in metrics.items():
            kind = m.get("type", "?")
            if kind == "histogram":
                val = (f"n={m.get('total')} mean={_fmt(m.get('mean'))} "
                       f"p50={_fmt(m.get('p50'))} p99={_fmt(m.get('p99'))}")
            else:
                val = _fmt(m.get("value"))
            lines.append(f"| {name} | {kind} | {val} |")
        lines.append("")

    trace = report.get("trace")
    if trace:
        lines += [
            "## Trace",
            "",
            f"{trace.get('n_events', 0)} events on {trace.get('n_tracks', 0)} "
            f"tracks spanning {_fmt(trace.get('span_ms'), 6)} ms "
            f"(open in Perfetto / `chrome://tracing`).",
            "",
        ]

    throughput = report.get("throughput")
    if throughput:
        lines += ["## Throughput (observability disabled)", "",
                  "```json", json.dumps(throughput, indent=2), "```", ""]

    return "\n".join(lines).rstrip() + "\n"


def write_report(report: Mapping, md_out: Optional[str] = None) -> str:
    """Render markdown; optionally write it to ``md_out``. Returns the text."""
    text = render_markdown(report)
    if md_out:
        with open(md_out, "w") as f:
            f.write(text)
    return text
