"""Span trees: one closed ``Trace`` per request or per index build.

The port's copy of the reference's ``repro.obs.trace``.  A ``Trace`` is a
root span plus one child span per pipeline stage.  Stage boundaries are
consecutive laps of one stopwatch, so the stage durations *telescope*:
their sum equals the end-to-end time exactly (modulo float rounding).

The offline build pipeline uses ``BUILD_STAGES`` (plan → compress →
repack → validate → stage → swap): the ``IndexManager`` closes one trace
per adaptation attempt, including the thread handoff of an async swap,
which lands inside the ``compress`` lap.  The serving paths record the
reference's taxonomies: ``SYNC_STAGES`` (route → dispatch → rescue →
unwind → reply) for ``PathServer.query``/``query_paths``, and
``ASYNC_STAGES`` (admission → queue_wait → stage → dispatch →
pipeline_wait → device_join → rescue → unwind → reply) through the
continuous batcher, where ``device_join`` is the ``Pending.wait`` of a
retired group, the one host sync of that path.

:class:`HeadSampler` decides once per request whether to build a trace
(deterministic leaky bucket at ``sample_rate``, no RNG), with an
always-sample override for requests slower than ``slow_ms``.

Below the stages a sampled request records *child spans*
(:class:`ChildSpan`): intervals on ``perf_counter_ns`` inside a stage or
inside another child span, which never enter ``stages``.  The serving code
opens them with :func:`span` and finds the request's trace through a
thread-local that :func:`stage_scope` sets, so an unsampled request (no
current trace) pays one lookup and one ``None`` check a span.  A span
opened with ``annotate=True`` also opens a ``torch.profiler`` annotation
of its own name while a profiler is enabled, so the profiler's host
timeline carries the port's names; only spans that launch no device work
do, since an annotation around a launch becomes a device-side interval.
"""

from __future__ import annotations

import itertools
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from .locks import make_lock
from .timing import monotonic_ns

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


#: request ids of the process, one per trace
_RIDS = itertools.count(1)


class ChildSpan:
    """One interval below a stage: its ``name``, its request's ``rid``, the
    name of the stage or span it sits under (``parent``; ``up`` is that
    span, None under a stage) and its ends on ``perf_counter_ns``.  Made
    by :func:`span`, whose ``with`` block it times."""

    __slots__ = ("name", "rid", "parent", "up", "start_ns", "end_ns",
                 "_trace", "_annotate")

    def __init__(self, trace: "Trace", name: str, annotate: bool):
        self.name = name
        self.rid = trace.rid
        self._trace = trace
        self._annotate = annotate   # the flag; once entered, the annotation

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "ChildSpan":
        tr = self._trace
        top = tr._open[-1]          # the stage, or the innermost open span
        if isinstance(top, ChildSpan):
            self.up, self.parent = top, top.name
        else:
            self.up, self.parent = None, top
        tr._open.append(self)
        tr.spans.append(self)
        self.start_ns = monotonic_ns()
        if self._annotate:
            self._annotate = _annotation(self.name)
        return self

    def __exit__(self, *exc) -> None:
        if self._annotate:
            self._annotate.__exit__(None, None, None)
        self.end_ns = monotonic_ns()
        self._trace._open.pop()
        self._trace = self._annotate = None

    def to_dict(self, t_start: float, children: list) -> dict:
        return {"name": self.name, "t0": self.start_ns * 1e-9 - t_start,
                "seconds": self.seconds, "rid": self.rid,
                "parent": self.parent, "children": children}


class Trace:
    """A closed span tree for one request: the stages, and the child
    spans recorded below them."""

    __slots__ = ("kind", "stages", "attrs", "t_start", "t_end", "closed",
                 "rid", "spans", "_open")

    def __init__(self, kind: str = "async", **attrs):
        self.kind = kind
        self.stages: Dict[str, float] = {}
        self.attrs: dict = attrs
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self.closed = False
        self.rid = next(_RIDS)
        self.spans: List[ChildSpan] = []    # in the order they opened
        self._open: list = []               # stage name, then open spans

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

    def _below(self, stage: Optional[str], up: Optional[ChildSpan]) -> list:
        t0 = self.t_start or 0.0
        return [sp.to_dict(t0, self._below(None, sp)) for sp in self.spans
                if sp.up is up and (up is not None or sp.parent == stage)]

    def tree(self) -> dict:
        """Root span with one child per stage, in taxonomy order, and the
        child spans nested under their stage."""
        order = STAGE_TAXONOMY.get(self.kind, SYNC_STAGES)
        names = [s for s in order if s in self.stages] + \
            [s for s in self.stages if s not in order]
        t, children = 0.0, []
        for name in names:
            dur = self.stages[name]
            children.append({**Span(name, t, dur).to_dict(),
                             "children": self._below(name, None)})
            t += dur
        return {"name": f"request/{self.kind}", "t0": 0.0, "rid": self.rid,
                "seconds": self.e2e_seconds, "attrs": dict(self.attrs),
                "closed": self.closed, "children": children}

    def to_dict(self) -> dict:
        return self.tree()


# ------------------------------------------------- the current trace
class _Local(threading.local):
    trace: Optional[Trace] = None   # a class default: no miss to raise


_LOCAL = _Local()


class _Null:
    """The context of an unsampled request: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


def current_trace() -> Optional[Trace]:
    """The trace of the request this thread serves now (None: unsampled,
    or outside a :func:`stage_scope`)."""
    return _LOCAL.trace


def _profiling() -> bool:
    """A torch profiler is recording (torch's own module-level flag; no
    torch import here)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _open_annotation(name: str):
    """A ``torch.profiler`` annotation called ``name`` (entered by the
    caller)."""
    from torch.autograd.profiler import record_function
    return record_function(name)


def _annotation(name: str):
    """An entered annotation while a profiler records, else None."""
    if not _profiling():
        return None
    rf = _open_annotation(name)
    rf.__enter__()
    return rf


class _Scope:
    """``trace`` is the thread's current trace, under ``stage``, for the
    length of a ``with`` block."""

    __slots__ = ("trace", "stage", "annotate", "prev", "rf")

    def __init__(self, trace: Trace, stage: str, annotate: bool):
        self.trace, self.stage, self.annotate = trace, stage, annotate

    def __enter__(self) -> Trace:
        self.prev = _LOCAL.trace
        _LOCAL.trace = self.trace
        self.trace._open.append(self.stage)
        self.rf = _annotation(self.stage) if self.annotate else None
        return self.trace

    def __exit__(self, *exc) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.trace._open.pop()
        _LOCAL.trace = self.prev
        self.prev = self.rf = None


def stage_scope(trace: Optional[Trace], stage: str, annotate: bool = False):
    """Make ``trace`` current under ``stage`` for a ``with`` block, so the
    engine code below records its child spans there; ``annotate``: the
    stage launches no device work, so a profiler sees its name.  Records
    no time: the stage's seconds stay the caller's lap.  No-op for an
    unsampled request (``trace`` None)."""
    return _NULL if trace is None else _Scope(trace, stage, annotate)


def span(name: str, annotate: bool = False):
    """A child span of the current trace for a ``with`` block, under the
    innermost open stage or span; a no-op without a current trace.
    ``annotate=True`` only for host work that launches nothing on the
    device."""
    tr = _LOCAL.trace
    return _NULL if tr is None else ChildSpan(tr, name, annotate)


def annotate(name: str):
    """A profiler annotation only (no span) around host work that launches
    nothing, for a sampled request while a profiler records."""
    if _LOCAL.trace is None or not _profiling():
        return _NULL
    return _open_annotation(name)


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
