"""Counter/gauge/histogram registry + an in-loop accumulation idiom (port
of ``repro.obs.metrics``).

Two halves:

* **Host registry** — :class:`Counter`, :class:`Gauge`, :class:`Histogram`
  (fixed ascending bucket edges, under/overflow buckets, interpolated
  percentiles) collected under a :class:`MetricsRegistry`.  Plain Python —
  used by the serving engine and the run-report generator.
* **In-loop accumulation** — :func:`hist_update` / :func:`scan_histogram`:
  histograms as fixed-width int64 count vectors updated with
  ``torch.searchsorted`` + ``index_add_`` on the tensor's own device, one
  tick at a time through the fleet's tick loop
  (:func:`repro_torch.fleet.step._run_loop`, CUDA graphs on a card) — the
  reference's ``.at[].add`` inside ``lax.scan``.  No step reads a value
  back to the host.  :func:`routed_metrics` applies it to a routed fleet
  run's per-tick latency trajectories and fills a registry with
  queue-depth, drop, and latency histograms.

The host registry is plain Python and numpy; torch is imported inside the
in-loop helpers only, so CLIs can build registries before touching a card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_latency_edges_ms",
    "fleet_queue_depth_edges",
    "hist_update",
    "scan_histogram",
    "routed_metrics",
]


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: increments must be >= 0")
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``len(edges) + 1`` counts (trailing overflow).

    ``counts[i]`` holds observations with ``edges[i-1] < x <= edges[i]``
    (``counts[0]``: x ≤ edges[0]; ``counts[-1]``: x > edges[-1]) — the
    ``np.searchsorted(edges, x, side="left")`` convention
    :func:`hist_update` uses (``torch.searchsorted(..., right=False)``), so host and in-scan counts agree exactly.

    >>> h = Histogram("latency_ms", edges=[1.0, 10.0, 100.0])
    >>> h.observe_many([0.5, 5.0, 50.0, 500.0])
    >>> h.counts.tolist()
    [1, 1, 1, 1]
    >>> h.total
    4
    """

    def __init__(self, name: str, edges: Sequence[float]):
        self.name = name
        edges = np.asarray(list(edges), dtype=np.float64)
        if edges.ndim != 1 or edges.size == 0:
            raise ValueError(f"histogram {name!r}: edges must be a 1-D sequence")
        if not np.all(np.diff(edges) > 0):
            raise ValueError(f"histogram {name!r}: edges must be strictly ascending")
        self.edges = edges
        self.counts = np.zeros(edges.size + 1, dtype=np.int64)
        self._sum = 0.0

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def observe(self, x: float) -> None:
        self.observe_many([x])

    def observe_many(self, xs, mask=None) -> None:
        xs = np.asarray(xs, dtype=np.float64).ravel()
        if mask is not None:
            xs = xs[np.asarray(mask, dtype=bool).ravel()]
        if xs.size == 0:
            return
        idx = np.searchsorted(self.edges, xs, side="left")
        np.add.at(self.counts, idx, 1)
        self._sum += float(xs.sum())

    def merge_counts(self, counts) -> None:
        """Fold an externally accumulated count vector (e.g. from
        :func:`scan_histogram`, same edges) into this histogram."""
        counts = np.asarray(counts, dtype=np.int64)
        if counts.shape != self.counts.shape:
            raise ValueError(
                f"histogram {self.name!r}: expected {self.counts.shape} counts, "
                f"got {counts.shape}"
            )
        self.counts = self.counts + counts

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated percentile (None while empty).

        The two open-ended buckets report their one finite edge — underflow
        (x ≤ edges[0], which may hold negative observations) returns
        edges[0], overflow (x > edges[-1]) returns edges[-1] — so no bound
        is ever invented outside the configured edge range.
        """
        total = self.total
        if total == 0:
            return None
        target = total * q / 100.0
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i == 0:
            return float(self.edges[0])
        if i >= self.edges.size:
            return float(self.edges[-1])
        lo = float(self.edges[i - 1])
        hi = float(self.edges[i])
        prev = float(cum[i - 1])
        frac = (target - prev) / max(float(self.counts[i]), 1.0)
        return lo + (hi - lo) * min(max(frac, 0.0), 1.0)

    @property
    def mean(self) -> Optional[float]:
        total = self.total
        return self._sum / total if total else None

    def to_dict(self) -> dict:
        return {
            "type": "histogram",
            "edges": self.edges.tolist(),
            "counts": self.counts.tolist(),
            "total": self.total,
            "mean": self.mean,
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """Get-or-create collection of named metrics, one namespace per run."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, edges: Sequence[float]) -> Histogram:
        h = self._get(name, Histogram, lambda: Histogram(name, edges))
        if not np.array_equal(h.edges, np.asarray(list(edges), dtype=np.float64)):
            raise ValueError(f"histogram {name!r} already registered with "
                             "different edges")
        return h

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def to_dict(self) -> dict:
        return {name: m.to_dict() for name, m in sorted(self._metrics.items())}


def default_latency_edges_ms(lo: float = 0.1, hi: float = 100_000.0,
                             per_decade: int = 4) -> np.ndarray:
    """Log-spaced latency bucket edges (ms), ``per_decade`` buckets/decade."""
    n = int(round(math.log10(hi / lo) * per_decade)) + 1
    return np.logspace(math.log10(lo), math.log10(hi), n)


def fleet_queue_depth_edges(queue_capacity: int, n_devices: int) -> np.ndarray:
    """Bucket edges for the fleet-total backlog histogram.

    The backlog sums over all devices, so the edges span the fleet-wide
    capacity ``queue_capacity * n_devices`` — unit-width integer buckets
    while that stays small, log-spaced integer edges beyond (a 256-device
    default fleet would otherwise need thousands of linear buckets).
    """
    cap_total = int(queue_capacity) * int(n_devices)
    if cap_total < 1:
        raise ValueError("fleet queue capacity must be positive")
    if cap_total <= 128:
        return np.arange(cap_total + 1, dtype=np.float64)
    return np.concatenate((
        [0.0],
        np.unique(np.round(np.logspace(0.0, math.log10(cap_total), 48))),
    ))


# ---------------------------------------------------------------------------
# In-loop accumulation on the tensor's device
# ---------------------------------------------------------------------------
def hist_update(counts, edges, values, mask=None):
    """One histogram update: scatter-add ``values`` into ``counts``.

    ``counts`` is an int64 ``(len(edges) + 1,)`` tensor, ``edges`` a float64
    tensor on its device.  Fixed shapes and no host read — safe inside a
    CUDA-graph capture; masked-out values land in a scratch bucket that is
    dropped, so the returned vector keeps shape ``(len(edges) + 1,)``.
    """
    import torch

    idx = torch.searchsorted(edges, values.reshape(-1).to(edges.dtype), right=False)
    n = counts.shape[0]
    if mask is not None:
        # masked entries go to an extra scratch slot past the overflow bucket
        idx = torch.where(mask.reshape(-1), idx, n)
    ext = torch.cat([counts, counts.new_zeros(1)])
    ext.index_add_(0, idx, torch.ones_like(idx, dtype=counts.dtype))
    return ext[:n]


def scan_histogram(values, edges, mask=None, device=None, jit: bool = True):
    """Histogram a ``(K, ...)`` trajectory one step at a time on the card.

    The in-loop metrics idiom: the bucket-count vector is the loop carry,
    each step scatter-adds its tick's values (through the fleet's tick loop,
    CUDA graphs on a card when ``jit``).  ``values`` runs on its own device
    when it is a tensor, else on ``device`` (default the card; ``"cpu"``
    runs the same program on the host).  Returns ``(len(edges) + 1,)``
    int64 counts (numpy) matching :meth:`Histogram.observe_many` exactly.

    >>> import numpy as np
    >>> vals = np.array([[0.5, 5.0], [50.0, 500.0]])
    >>> scan_histogram(vals, [1.0, 10.0, 100.0], device="cpu").tolist()
    [1, 1, 1, 1]
    """
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.fleet.step import _run_loop

    if isinstance(values, torch.Tensor) and device is None:
        dev = values.device
    else:
        dev = resolve_device("cuda" if device is None else device)
    values = torch.as_tensor(values).to(device=dev, dtype=torch.float64)
    edges_t = torch.as_tensor(np.asarray(list(np.ravel(edges)), dtype=np.float64)).to(dev)
    mask_t = (torch.ones(values.shape, dtype=torch.bool, device=dev) if mask is None
              else torch.as_tensor(mask).to(device=dev, dtype=torch.bool))
    counts0 = torch.zeros(edges_t.shape[0] + 1, dtype=torch.int64, device=dev)

    def body(carry, x):
        v, m = x
        return (hist_update(carry[0], edges_t, v, m),), ()

    (counts,), _ = _run_loop(body, (counts0,), (values, mask_t), int(values.shape[0]), jit)
    return counts.cpu().numpy()


def routed_metrics(result, registry: Optional[MetricsRegistry] = None,
                   latency_edges=None) -> MetricsRegistry:
    """Fill a registry from a :class:`repro_torch.fleet.step.RoutedFleetResult`.

    Counters (served/dropped/configurations/releases), gauges (devices
    alive, queued backlog), a queue-depth histogram, and — when the run
    collected latency trajectories — a latency histogram accumulated by
    :func:`scan_histogram` over the ``(K, N)`` per-tick tensors on the
    run's device.
    """
    from repro_torch.fleet.step import _np

    reg = registry if registry is not None else MetricsRegistry()
    s = result.state
    reg.counter("requests_served").inc(int(np.sum(_np(s.n_served))))
    reg.counter("requests_dropped").inc(int(np.sum(_np(s.n_dropped))))
    reg.counter("configurations").inc(int(np.sum(_np(s.n_configs))))
    reg.counter("timeout_releases").inc(int(np.sum(_np(s.n_released))))
    alive = _np(s.alive)
    reg.gauge("devices_alive").set(int(alive.sum()))
    reg.gauge("devices_dead").set(int((~alive).sum()))
    reg.gauge("queued_requests").set(int(np.sum(_np(s.q_len))))

    n_dev, qcap = (int(d) for d in s.queue_ms.shape)
    qh = reg.histogram("fleet_queue_depth",
                       edges=fleet_queue_depth_edges(qcap, n_dev))
    qh.observe_many(_np(result.queued_over_time).astype(np.float64))

    if result.latency_ms is not None and result.served_mask is not None:
        edges = (default_latency_edges_ms() if latency_edges is None
                 else latency_edges)
        lh = reg.histogram("request_latency_ms", edges=edges)
        counts = scan_histogram(result.latency_ms, edges, mask=result.served_mask)
        lh.merge_counts(counts)
        lat = _np(result.latency_ms).astype(np.float64)
        lh._sum += float(lat[_np(result.served_mask)].sum())
    return reg
