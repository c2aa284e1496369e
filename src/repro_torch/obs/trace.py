"""Structured state-transition traces, exportable as Chrome-trace JSON
(port of ``repro.obs.trace``).

The discrete-event paths (``simulate_trace``, the routed fleet kernel) emit
typed events — request arrivals, idle spans, timeout releases,
(re)configurations, service spans, budget exhaustion — into a
:class:`TraceRecorder`.  :meth:`TraceRecorder.to_chrome` serializes them in
the Chrome Trace Event format (the ``traceEvents`` JSON both
``chrome://tracing`` and Perfetto open directly): durations are ``X``
(complete) events, point events are ``I`` (instant), fleet-level time
series are ``C`` (counter) events, and tracks get ``M`` (metadata) names.

Times are milliseconds at the recorder API (this repo's unit convention)
and microseconds in the exported JSON (the trace format's convention).

:func:`validate_chrome_trace` is the schema check the tests and the obs CLI
run on every export: required fields present, timestamps finite/monotonic
per track, ``B``/``E`` stack-paired, ``X`` durations non-negative.

:func:`routed_timeline` reconstructs a per-device timeline from a routed
fleet run launched with ``collect_events=True`` — the fleet's tick loop
never calls back to the host; events are rebuilt afterwards from the
collected per-tick masks.  Plain Python and numpy: no torch import.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np

__all__ = [
    "TraceEvent",
    "TraceRecorder",
    "validate_chrome_trace",
    "routed_timeline",
]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace event (times in ms; ``dur_ms`` only for ``ph == 'X'``)."""

    name: str
    ph: str                  # X (complete), I (instant), B/E (span), C (counter)
    ts_ms: float
    track: str
    dur_ms: float = 0.0
    args: Optional[dict] = None


class TraceRecorder:
    """Accumulates :class:`TraceEvent` records and exports Chrome-trace JSON.

    Tracks ("device", "requests", a per-device "dev 3", ...) become trace
    threads; the recorder owns the track→tid mapping so callers only name
    tracks.  Recording is plain list appends — cheap enough for the
    discrete-event (host) paths; the tick loops never call it.
    """

    def __init__(self, process: str = "repro"):
        self.process = process
        self.events: list[TraceEvent] = []
        self._tids: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.events)

    def _check_ts(self, name: str, ts_ms: float) -> float:
        ts_ms = float(ts_ms)
        if not math.isfinite(ts_ms) or ts_ms < 0:
            raise ValueError(
                f"event {name!r}: timestamp must be finite and non-negative, "
                f"got {ts_ms}"
            )
        return ts_ms

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids)
        return tid

    # ---- recording -----------------------------------------------------------
    def instant(self, name: str, ts_ms: float, track: str = "main", **args) -> None:
        self._tid(track)
        self.events.append(
            TraceEvent(name, "I", self._check_ts(name, ts_ms), track,
                       args=args or None)
        )

    def complete(self, name: str, ts_ms: float, dur_ms: float,
                 track: str = "main", **args) -> None:
        dur_ms = float(dur_ms)
        if not math.isfinite(dur_ms) or dur_ms < 0:
            raise ValueError(
                f"event {name!r}: duration must be finite and non-negative, "
                f"got {dur_ms}"
            )
        self._tid(track)
        self.events.append(
            TraceEvent(name, "X", self._check_ts(name, ts_ms), track,
                       dur_ms=dur_ms, args=args or None)
        )

    def begin(self, name: str, ts_ms: float, track: str = "main", **args) -> None:
        self._tid(track)
        self.events.append(
            TraceEvent(name, "B", self._check_ts(name, ts_ms), track,
                       args=args or None)
        )

    def end(self, name: str, ts_ms: float, track: str = "main", **args) -> None:
        self._tid(track)
        self.events.append(
            TraceEvent(name, "E", self._check_ts(name, ts_ms), track,
                       args=args or None)
        )

    def counter(self, name: str, ts_ms: float, values: dict,
                track: str = "counters") -> None:
        self._tid(track)
        self.events.append(
            TraceEvent(name, "C", self._check_ts(name, ts_ms), track,
                       args={k: float(v) for k, v in values.items()})
        )

    # ---- export ----------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The ``{"traceEvents": [...]}`` payload ``chrome://tracing`` /
        Perfetto open; events sorted by timestamp, one thread per track."""
        out = []
        pid = 1
        out.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.process},
        })
        for track, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": track},
            })
        for ev in sorted(self.events, key=lambda e: (e.ts_ms, e.ph != "E")):
            rec = {
                "name": ev.name,
                "ph": ev.ph,
                "ts": ev.ts_ms * 1000.0,          # ms → µs
                "pid": pid,
                "tid": self._tids[ev.track],
            }
            if ev.ph == "X":
                rec["dur"] = ev.dur_ms * 1000.0
            if ev.ph == "I":
                rec["s"] = "t"                     # thread-scoped instant
            if ev.args is not None:
                rec["args"] = ev.args
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write(self, path: str) -> dict:
        """Validate, then write the Chrome-trace JSON to ``path``."""
        payload = self.to_chrome()
        problems = validate_chrome_trace(payload)
        if problems:
            raise ValueError(
                "refusing to write a malformed trace: " + "; ".join(problems[:5])
            )
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return payload


def validate_chrome_trace(payload) -> list[str]:
    """Schema check of a Chrome-trace payload; returns problem strings
    (empty = valid).  Enforced: ``traceEvents`` list of dicts with
    name/ph/ts/pid/tid, finite non-negative timestamps, per-track monotonic
    ordering, non-negative ``X`` durations, stack-paired ``B``/``E``."""
    problems: list[str] = []
    if not isinstance(payload, dict) or not isinstance(
        payload.get("traceEvents"), list
    ):
        return ["payload must be a dict with a 'traceEvents' list"]
    last_ts: dict[tuple, float] = {}
    stacks: dict[tuple, list[str]] = {}
    for i, ev in enumerate(payload["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        missing = [k for k in ("name", "ph", "pid", "tid") if k not in ev]
        if ev.get("ph") != "M" and "ts" not in ev:
            missing.append("ts")
        if missing:
            problems.append(f"event {i} missing fields {missing}")
            continue
        ph = ev["ph"]
        if ph == "M":
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) or ts < 0:
            problems.append(f"event {i} ({ev['name']!r}) has bad ts {ts!r}")
            continue
        key = (ev["pid"], ev["tid"])
        if ts < last_ts.get(key, 0.0):
            problems.append(
                f"event {i} ({ev['name']!r}) breaks monotonic ts on track {key}"
            )
        last_ts[key] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) or dur < 0:
                problems.append(f"event {i} ({ev['name']!r}) has bad dur {dur!r}")
        elif ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                problems.append(
                    f"event {i} ({ev['name']!r}): E without matching B on {key}"
                )
            else:
                stack.pop()
        elif ph not in ("I", "C"):
            problems.append(f"event {i} has unknown phase {ph!r}")
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B events {stack} on track {key}")
    return problems


def routed_timeline(result, max_devices: int = 32,
                    max_counter_points: int = 256) -> TraceRecorder:
    """Rebuild a per-device timeline from a routed fleet run.

    ``result`` is a :class:`repro_torch.fleet.step.RoutedFleetResult` from
    ``run_routed(..., collect_events=True)``; the per-tick serve /
    reconfigure / release masks and queue depths collected by the loop are
    turned into one trace track per device (first ``max_devices``), plus
    fleet-level counter tracks (devices alive, queued requests, drops).
    """
    if result.served_mask is None or result.reconfig_mask is None:
        raise ValueError(
            "routed_timeline needs a run launched with collect_latency=True "
            "and collect_events=True"
        )
    from repro_torch.fleet.step import _np

    # the reference's process name, so both packages export the same trace
    rec = TraceRecorder(process="repro.fleet.routed")
    dt = result.dt_ms
    n_dev = min(int(result.params.n_devices), max_devices)
    t_exec = _np(result.params.t_exec_ms)
    t_config = _np(result.params.t_config_ms)

    served = _np(result.served_mask)[:, :n_dev]
    reconf = _np(result.reconfig_mask)[:, :n_dev]
    released = _np(result.released_mask)[:, :n_dev]

    n_reconf_seen = np.zeros(n_dev, dtype=np.int64)
    for k, d in zip(*np.nonzero(served)):
        now = float(k) * dt
        track = f"dev {d}"
        if released[k, d]:
            rec.instant("timeout_release", now, track=track)
        start = now
        if reconf[k, d]:
            # the initial bring-up is pre-staged (no service delay); inline
            # reconfigurations delay the service span by t_config
            if n_reconf_seen[d] == 0:
                rec.instant("initial_configuration", start, track=track)
            else:
                rec.complete("configure", start, float(t_config[d]), track=track)
                start += float(t_config[d])
            n_reconf_seen[d] += 1
        rec.complete("serve", start, float(t_exec[d]), track=track, tick=int(k))

    # fleet-level counters, downsampled to ≤ max_counter_points
    n_steps = int(result.n_steps)
    stride = max(1, -(-n_steps // max_counter_points))
    alive = _np(result.alive_over_time)
    queued = _np(result.queued_over_time)
    drops = result.dropped_per_tick
    cum_drops = None if drops is None else np.cumsum(_np(drops).sum(axis=1))
    for k in range(0, n_steps, stride):
        ts = float(k) * dt
        rec.counter("devices_alive", ts, {"alive": int(alive[k])})
        rec.counter("queued_requests", ts, {"queued": int(queued[k])})
        if cum_drops is not None:
            rec.counter("drops", ts, {"dropped": int(cum_drops[k])})
    return rec
