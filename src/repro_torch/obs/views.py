"""Registry-backed stats views (the port's copy of ``repro.obs.views``).

The serving stack's public stats objects (``ServeStats``/``BucketStats``/
``ShardStats``) keep their dataclass-era field surface — ``stats.queries
+= n``, ``stats.seconds = 0.0`` — but every counter/gauge field is a
property over a registry series, so the Prometheus/JSON exports and the
in-process views are the same numbers by construction.

Each view instance binds its series under its own unique ``row`` label
(plus semantic labels like ``srv``/``bucket``/``gen``): a *fresh view is
a fresh series*, which preserves the old value semantics exactly (a new
``ServeStats()`` starts at zero; a per-bucket dict reset on hot-swap
starts new generation-tagged series while the retired generation's rows
stay frozen in the registry).
"""

from __future__ import annotations

from .metrics import MetricsRegistry, REGISTRY, next_instance_id


def _make_property(field: str, cast):
    def fget(self):
        return cast(self._series[field].value)

    def fset(self, v):
        self._series[field].set(v)

    return property(fget, fset, doc=f"registry-backed field {field!r}")


class StatsView:
    """Base: subclasses declare ``_COUNTERS``/``_GAUGES`` maps of
    ``field -> (metric_name, cast)`` and call ``_bind`` in __init__."""

    _COUNTERS: dict = {}
    _GAUGES: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for field, (_, cast) in {**cls._COUNTERS, **cls._GAUGES}.items():
            setattr(cls, field, _make_property(field, cast))

    def _bind(self, registry: MetricsRegistry = None, labels: dict = None,
              row_prefix: str = "v") -> None:
        self.registry = REGISTRY if registry is None else registry
        lbl = {k: str(v) for k, v in (labels or {}).items()}
        lbl.setdefault("row", next_instance_id(row_prefix))
        self.labels = lbl
        self._series = {}
        for field, (name, _) in self._COUNTERS.items():
            self._series[field] = self.registry.counter(name, **lbl)
        for field, (name, _) in self._GAUGES.items():
            self._series[field] = self.registry.gauge(name, **lbl)

    def counters(self) -> dict:
        return {f: getattr(self, f)
                for f in {**self._COUNTERS, **self._GAUGES}}

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in self.counters().items())
        return f"{type(self).__name__}({kv})"
