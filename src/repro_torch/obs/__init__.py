"""Observability of the port: named locks, metrics, spans and events.

The port's copies of the jax-free parts of the reference's ``repro.obs``:

* :func:`make_lock` — named locks with a declared order (``locks``);
* :class:`MetricsRegistry` — labeled counters/gauges/histograms, with the
  process-wide :data:`REGISTRY` (``metrics``);
* :class:`Trace`/:class:`TraceLog`/:class:`HeadSampler` — span trees,
  head-sampled (``trace``);
* :class:`EventLog` — structured ring + JSONL sink for discrete state
  changes (``events``);
* :class:`Stopwatch` — the monotonic duration clock (``timing``).

:class:`Telemetry` bundles sampler + trace ring + event log over a
registry (the shared :data:`REGISTRY` by default).  The reference's
profile capture, exporters and stats views come with the observability
slice.
"""

from .events import EventLog
from .locks import (LOCK_RANKS, LockOrderError, OrderedLock,
                    lock_check_enabled, make_lock)
from .metrics import (DEFAULT_LATENCY_BOUNDS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry, REGISTRY, log_bounds,
                      next_instance_id)
from .timing import Stopwatch, monotonic
from .trace import (ASYNC_STAGES, BUILD_STAGES, SYNC_STAGES, HeadSampler,
                    Span, Trace, TraceLog)

__all__ = [
    "ASYNC_STAGES", "BUILD_STAGES", "SYNC_STAGES", "Counter",
    "DEFAULT_LATENCY_BOUNDS_MS", "EventLog", "Gauge", "HeadSampler",
    "Histogram", "LOCK_RANKS", "LockOrderError", "MetricsRegistry",
    "OrderedLock", "REGISTRY", "Span", "Stopwatch", "Telemetry", "Trace",
    "TraceLog", "lock_check_enabled", "log_bounds", "make_lock",
    "monotonic", "next_instance_id",
]


class Telemetry:
    """Sampler + trace ring + event log over a shared metrics registry."""

    def __init__(self, registry: MetricsRegistry = None,
                 sample_rate: float = 0.05, slow_ms: float = 50.0,
                 events: EventLog = None, span_capacity: int = 1024,
                 events_path: str = None):
        self.registry = REGISTRY if registry is None else registry
        self.sampler = HeadSampler(rate=sample_rate, slow_ms=slow_ms)
        self.spans = TraceLog(capacity=span_capacity)
        self.events = EventLog(path=events_path) if events is None \
            else events

    @classmethod
    def off(cls, registry: MetricsRegistry = None) -> "Telemetry":
        """Spans and events disabled; registry recording stays on."""
        t = cls(registry=registry, sample_rate=0.0, slow_ms=0.0)
        t.events.enabled = False
        return t

    @property
    def enabled(self) -> bool:
        return (self.sampler.rate > 0.0 or self.sampler.slow_ms > 0.0
                or self.events.enabled)
