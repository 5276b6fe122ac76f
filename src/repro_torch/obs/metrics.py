"""Process-wide metrics registry: counters, gauges, latency histograms.

The port's copy of the reference's ``repro.obs.metrics`` (stdlib and numpy
only).  The adaptive-indexing subsystem records its planner and build
series here; the serving stats move onto it with the observability slice.

Design notes
------------
* **Labeled series.** A metric is identified by ``(name, labels)`` where
  ``labels`` is a frozen, sorted tuple of ``(key, value)`` string pairs.
  Per-instance labels (``planner="p3"``) are how a process-wide registry
  serves many instances without cross-talk.
* **Histograms** use fixed log-spaced bucket bounds.  ``quantile(q)``
  returns the smallest bucket upper bound covering rank ``ceil(q*n)`` —
  exactly numpy's ``method="inverted_cdf"`` when samples sit on bucket
  boundaries, and within one bucket's resolution (``10**(1/per_decade)``)
  otherwise.  Counts are plain int64 numpy arrays, so shard-merge is
  element-wise addition.
* **Thread safety.** Every mutation takes the metric's own lock; the
  registry lock only guards series creation.  Recording is O(1) (or one
  ``searchsorted`` for histograms) — cheap enough for the dispatch loop,
  which records per *group*, not per query (per-query latencies go
  through the vectorized ``record_many``).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .locks import make_lock

LabelKey = Tuple[Tuple[str, str], ...]

_IDS = itertools.count(1)


def next_instance_id(prefix: str) -> str:
    """Unique per-process instance label value (``s1``, ``e2``, ...)."""
    return f"{prefix}{next(_IDS)}"


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def log_bounds(lo: float, hi: float, per_decade: int = 8) -> np.ndarray:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return np.asarray(lo * 10.0 ** (np.arange(n) / per_decade))


#: Default latency bounds: 1 ns .. 60 s expressed in ms, 8 buckets/decade
#: (resolution 10**(1/8) ~ 1.33x — tight enough for p99 regression gates).
DEFAULT_LATENCY_BOUNDS_MS = log_bounds(1e-6, 6e4, 8)


class Counter:
    """Monotonic-by-convention float counter (settable for view resets)."""

    __slots__ = ("name", "labels", "_value", "_lock")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = make_lock("obs.series")

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def merge(self, other: "Counter") -> None:
        self.inc(other.value)

    def snapshot(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "value": self._value}


class Gauge(Counter):
    """Same storage as Counter; distinct type for export semantics."""

    __slots__ = ()

    def merge(self, other: "Counter") -> None:  # gauges take the max
        with self._lock:
            self._value = max(self._value, other.value)


class Histogram:
    """Fixed-bucket histogram with exact rank-based quantile readback."""

    __slots__ = ("name", "labels", "bounds", "counts", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, labels: LabelKey = (),
                 bounds: Optional[np.ndarray] = None):
        self.name = name
        self.labels = labels
        self.bounds = np.asarray(
            DEFAULT_LATENCY_BOUNDS_MS if bounds is None else bounds,
            dtype=np.float64)
        if self.bounds.ndim != 1 or len(self.bounds) < 1 or \
                np.any(np.diff(self.bounds) <= 0):
            raise ValueError("bounds must be a 1-D increasing array")
        # counts[i] <= bounds[i]; counts[-1] is the +Inf overflow bucket.
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = make_lock("obs.series")

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def record(self, v: float) -> None:
        i = int(np.searchsorted(self.bounds, v, side="left"))
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def record_many(self, vs: Iterable[float]) -> None:
        a = np.asarray(list(vs) if not isinstance(vs, np.ndarray) else vs,
                       dtype=np.float64)
        if a.size == 0:
            return
        idx = np.searchsorted(self.bounds, a, side="left")
        add = np.bincount(idx, minlength=len(self.counts))
        with self._lock:
            self.counts += add.astype(np.int64)
            self.sum += float(a.sum())
            self.min = min(self.min, float(a.min()))
            self.max = max(self.max, float(a.max()))

    def quantile(self, q: float) -> float:
        """Smallest bucket upper bound whose CDF covers rank ceil(q*n).

        Matches ``np.quantile(data, q, method="inverted_cdf")`` exactly
        when every sample equals a bucket bound; otherwise overshoots by
        at most one bucket (documented resolution).
        """
        n = self.count
        if n == 0:
            return math.nan
        rank = max(1, int(math.ceil(q * n)))
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        if i >= len(self.bounds):  # overflow bucket: best bound is max seen
            return self.max
        # Clip to observed extremes so tiny samples read back exactly.
        return float(min(max(self.bounds[i], self.min), self.max))

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> Dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def merge(self, other: "Histogram") -> None:
        if len(other.bounds) != len(self.bounds) or \
                not np.allclose(other.bounds, self.bounds):
            raise ValueError(f"histogram {self.name}: bounds mismatch")
        with self._lock:
            self.counts += other.counts
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)

    def snapshot(self) -> dict:
        d = {"name": self.name, "labels": dict(self.labels),
             "count": self.count, "sum": self.sum,
             "min": None if math.isinf(self.min) else self.min,
             "max": None if math.isinf(self.max) else self.max,
             "bounds": [float(b) for b in self.bounds],
             "counts": [int(c) for c in self.counts]}
        d.update({k: (None if math.isnan(v) else v)
                  for k, v in self.percentiles().items()})
        return d


class MetricsRegistry:
    """Get-or-create store of labeled Counter/Gauge/Histogram series."""

    def __init__(self):
        self._lock = make_lock("obs.registry")
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls) or (cls is Counter
                                      and isinstance(m, Gauge)):
            raise TypeError(f"metric {name} already registered as "
                            f"{type(m).__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Optional[np.ndarray] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def series(self, name: str) -> List[object]:
        """All series registered under ``name`` (any labels)."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def find(self, name: str, **labels):
        """Series under ``name`` whose labels contain ``labels``."""
        want = set(_label_key(labels))
        return [m for m in self.series(name)
                if want.issubset(set(m.labels))]

    def names(self) -> List[str]:
        with self._lock:
            return sorted({n for (n, _) in self._metrics})

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry (e.g. a shard's) into this one."""
        for m in other.metrics():
            labels = dict(m.labels)
            if isinstance(m, Histogram):
                mine = self.histogram(m.name, bounds=m.bounds, **labels)
            elif isinstance(m, Gauge):
                mine = self.gauge(m.name, **labels)
            else:
                mine = self.counter(m.name, **labels)
            mine.merge(m)

    def snapshot(self) -> dict:
        out = {"counters": [], "gauges": [], "histograms": []}
        for m in self.metrics():
            kind = ("histograms" if isinstance(m, Histogram) else
                    "gauges" if isinstance(m, Gauge) else "counters")
            out[kind].append(m.snapshot())
        for v in out.values():
            v.sort(key=lambda d: (d["name"], sorted(d["labels"].items())))
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


#: The process-wide default registry: everything records here unless handed
#: an explicit registry.
REGISTRY = MetricsRegistry()
