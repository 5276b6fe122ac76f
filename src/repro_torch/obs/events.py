"""Structured event log for discrete serving/indexing state changes.

Events are append-only dicts with a monotone sequence number and a
monotonic timestamp ``ts_mono`` (for ordering against span data; the port
takes no wall-clock reading).  The log keeps a bounded
in-memory ring and can optionally tee every event to a JSONL file sink.

Event taxonomy (DESIGN.md §12), as the port emits it:

=================  ===================================================
swap               IndexManager committed a hot-swap (generation, kind,
                   drift, build/pack/validate seconds, bytes, regions)
swap_abort         validation/budget gate rejected a candidate artifact
drift              the manager acts on a planner decision
plan_decision      BudgetPlanner decided to act (budget, alarm, dwell)
plan_execute       BudgetPlanner recompressed (bytes and regions in/out)
quant_fallback     a quantized bucket went loud (per-bucket f32 fallback
                   counts from the artifact's ``quant_stats``)
shed               backpressure dropped a submit (policy="shed")
requeue            a staged group was superseded by a swap and re-routed
                   under the live generation
covis_assist       a sharded dispatch needed cross-shard co-visibility
                   verdicts (count per staged group)
=================  ===================================================
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import List, Optional

from .locks import make_lock


class EventLog:
    """Bounded ring + optional JSONL file sink."""

    def __init__(self, capacity: int = 4096, path: Optional[str] = None,
                 enabled: bool = True):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = make_lock("obs.events")
        self._seq = 0
        self._fh = None
        self.enabled = enabled
        self.path = None
        if path is not None:
            self.open_sink(path)

    def open_sink(self, path: str) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
            self.path = path
            self._fh = open(path, "a", buffering=1)

    def close_sink(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def emit(self, kind: str, **fields) -> Optional[dict]:
        if not self.enabled:
            return None
        ev = {"kind": kind, "ts_mono": time.perf_counter(), **fields}
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            if self._fh is not None:
                self._fh.write(json.dumps(ev, default=_jsonable) + "\n")
        return ev

    def events(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._ring)
        return evs if kind is None else [e for e in evs
                                         if e["kind"] == kind]

    def counts(self) -> dict:
        out: dict = {}
        for e in self.events():
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out

    def dump_jsonl(self, path: str) -> int:
        evs = self.events()
        with open(path, "w") as fh:
            for e in evs:
                fh.write(json.dumps(e, default=_jsonable) + "\n")
        return len(evs)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def _jsonable(o):
    """Best-effort JSON coercion for numpy scalars and odd field types."""
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    return str(o)
