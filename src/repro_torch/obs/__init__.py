"""Observability of the port: serving telemetry and attribution.

The port's copies of the jax-free parts of the reference's ``repro.obs``
(DESIGN.md §12-§13):

* :class:`MetricsRegistry` — labeled counters/gauges/histograms; the
  process-wide :data:`REGISTRY` is the single source of truth that the
  ``ServeStats``/``BucketStats``/``ShardStats`` views
  (:class:`StatsView`) and the Prometheus/JSON exporters
  (:func:`prometheus_text`, :func:`json_snapshot`) read;
* :class:`Trace`/:class:`TraceLog`/:class:`HeadSampler` — per-request
  span trees, head-sampled with an always-sample-on-slow override;
* :class:`EventLog` — structured ring + JSONL sink for discrete state
  changes (swaps, drift, sheds, requeues, quant fallbacks, covis);
* :class:`CompileCapture` (:func:`enable_profile`) — cold serving entries,
  per-entry device time from CUDA events and analytic kernel costs;
* :func:`make_lock` — named locks with a declared order;
  :class:`Stopwatch` — the monotonic duration clock.

:class:`Telemetry` bundles sampler + trace ring + event log (the registry
defaults to the shared :data:`REGISTRY`).  ``Telemetry.off()`` builds the
disabled variant: sampling rate 0, events suppressed — the registry stays
live because it *is* the serving stats.  The reference's XLA-only
``aot_cost`` and ``normalize_cost`` have no counterpart.
"""

from .events import EventLog
from .locks import (LOCK_RANKS, LockOrderError, OrderedLock, held_locks,
                    lock_check_enabled, make_lock)
from .metrics import (DEFAULT_LATENCY_BOUNDS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry, REGISTRY, log_bounds,
                      next_instance_id)
from .export import json_snapshot, parse_prometheus, prometheus_text
from .profile import (CompileCapture, CompileRecord, disable_profile,
                      enable_profile, kernel_cost, profiled)
from .timing import Stopwatch, monotonic
from .trace import (ASYNC_STAGES, BUILD_STAGES, SYNC_STAGES, HeadSampler,
                    Span, Trace, TraceLog)
from .views import StatsView

__all__ = [
    "ASYNC_STAGES", "BUILD_STAGES", "SYNC_STAGES",
    "CompileCapture", "CompileRecord", "Counter",
    "DEFAULT_LATENCY_BOUNDS_MS",
    "EventLog", "Gauge", "HeadSampler", "Histogram", "LOCK_RANKS",
    "LockOrderError", "MetricsRegistry", "OrderedLock",
    "REGISTRY", "Span", "StatsView", "Stopwatch", "Telemetry", "Trace",
    "TraceLog",
    "disable_profile", "enable_profile", "held_locks",
    "json_snapshot", "kernel_cost", "lock_check_enabled", "log_bounds",
    "make_lock", "monotonic", "next_instance_id",
    "parse_prometheus", "profiled", "prometheus_text",
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
