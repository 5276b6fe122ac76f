"""Span trees: one closed ``Trace`` per request or per index build.

The port's copy of the reference's ``repro.obs.trace``.  A ``Trace`` is a
root span plus one child span per pipeline stage.  Stage boundaries are
consecutive laps of one stopwatch, so the stage durations *telescope*:
their sum equals the end-to-end time exactly (modulo float rounding).

The offline build pipeline uses ``BUILD_STAGES`` (plan → compress →
repack → validate → stage → swap): the ``IndexManager`` closes one trace
per adaptation attempt, including the thread handoff of an async swap,
which lands inside the ``compress`` lap.  The serving taxonomies
(``ASYNC_STAGES``, ``SYNC_STAGES``) are kept with the reference's names;
the port's serving paths record them with the observability slice.

:class:`HeadSampler` decides once per request whether to build a trace
(deterministic leaky bucket at ``sample_rate``, no RNG), with an
always-sample override for requests slower than ``slow_ms``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from .locks import make_lock

ASYNC_STAGES: Tuple[str, ...] = (
    "admission", "queue_wait", "stage", "dispatch", "pipeline_wait",
    "device_join", "rescue", "unwind", "reply")

SYNC_STAGES: Tuple[str, ...] = (
    "route", "dispatch", "rescue", "unwind", "reply")

BUILD_STAGES: Tuple[str, ...] = (
    "plan", "compress", "repack", "validate", "stage", "swap")

STAGE_TAXONOMY: Dict[str, Tuple[str, ...]] = {
    "async": ASYNC_STAGES,
    "sync": SYNC_STAGES,
    "build": BUILD_STAGES,
}


class Span:
    """One named interval; ``t0`` is relative to the trace root (s)."""

    __slots__ = ("name", "t0", "seconds")

    def __init__(self, name: str, t0: float, seconds: float):
        self.name = name
        self.t0 = t0
        self.seconds = seconds

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "seconds": self.seconds}


class Trace:
    """A closed span tree for one request."""

    __slots__ = ("kind", "stages", "attrs", "t_start", "t_end", "closed")

    def __init__(self, kind: str = "async", **attrs):
        self.kind = kind
        self.stages: Dict[str, float] = {}
        self.attrs: dict = attrs
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.closed = False

    def stage(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + float(seconds)

    def close(self, t_start: float, t_end: float,
              outcome: str = "ok") -> "Trace":
        self.t_start = t_start
        self.t_end = t_end
        self.attrs["outcome"] = outcome
        self.closed = True
        return self

    @property
    def e2e_seconds(self) -> float:
        if self.t_start is None or self.t_end is None:
            return 0.0
        return self.t_end - self.t_start

    @property
    def stage_sum(self) -> float:
        return sum(self.stages.values())

    def complete(self, required=None) -> bool:
        req = STAGE_TAXONOMY.get(self.kind, SYNC_STAGES) \
            if required is None else required
        return self.closed and all(s in self.stages for s in req)

    def tree(self) -> dict:
        """Root span with one child per stage, in taxonomy order."""
        order = STAGE_TAXONOMY.get(self.kind, SYNC_STAGES)
        names = [s for s in order if s in self.stages] + \
            [s for s in self.stages if s not in order]
        t, children = 0.0, []
        for name in names:
            dur = self.stages[name]
            children.append(Span(name, t, dur).to_dict())
            t += dur
        return {"name": f"request/{self.kind}", "t0": 0.0,
                "seconds": self.e2e_seconds, "attrs": dict(self.attrs),
                "closed": self.closed, "children": children}

    def to_dict(self) -> dict:
        return self.tree()


class HeadSampler:
    """Deterministic leaky-bucket head sampler with a slow-path override.

    ``sample()`` is called at admission; ``slow(e2e_s)`` at retire for
    requests that were not head-sampled.  Rate 0 disables head sampling
    entirely (slow-path tracing still applies unless ``slow_ms`` is 0).
    """

    def __init__(self, rate: float = 0.05, slow_ms: float = 50.0):
        self.rate = float(rate)
        self.slow_ms = float(slow_ms)
        self._acc = 0.0
        self._lock = make_lock("obs.sampler")

    def sample(self) -> bool:
        if self.rate <= 0.0:
            return False
        with self._lock:
            self._acc += self.rate
            if self._acc >= 1.0:
                self._acc -= 1.0
                return True
        return False

    def slow(self, e2e_seconds: float) -> bool:
        return self.slow_ms > 0.0 and e2e_seconds * 1e3 >= self.slow_ms


class TraceLog:
    """Bounded ring of closed traces (newest kept)."""

    def __init__(self, capacity: int = 1024):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = make_lock("obs.spans")
        self.recorded = 0

    def add(self, trace: Trace) -> None:
        with self._lock:
            self._ring.append(trace)
            self.recorded += 1

    def traces(self, kind: Optional[str] = None) -> List[Trace]:
        with self._lock:
            ts = list(self._ring)
        return ts if kind is None else [t for t in ts if t.kind == kind]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
