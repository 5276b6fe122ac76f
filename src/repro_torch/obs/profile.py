"""Cold-entry and kernel-cost attribution for the serving entries
(DESIGN.md §13), the port's counterpart of ``repro.obs.profile``.

Every fold/join/gather entry of ``core.packed`` is wrapped by a small
dispatcher (``packed._serving_entry``) that adds one attribute read per
call.  When profiling is enabled (:func:`enable_profile`), the dispatcher
routes through a :class:`CompileCapture`.  The entry's ``TRACES.see``
bumps a thread-local count when it meets a cold shape key, so a changed
count across the call means this call was the first of its key on this
thread: the call that paid any nvcc build, ctypes load, new allocator
segment or pinned slot of that shape.  ``TRACES`` itself counts every
cold key on ``entry_cold_total{entry=}`` in the process-wide registry,
capture or not.  Per entry label the capture records, in its registry:

* ``entry_cold_seconds_total{entry=}`` — the wall time of the cold calls;
* ``entry_cold_output_bytes_total{entry=}`` — the bytes of the cold
  call's outputs (``.nbytes`` over the result leaves);
* with ``timing=True``, ``entry_stream_ms{entry=}`` — the stream time of
  every call of the entry, between two CUDA events recorded on the
  current stream around it.  The events are queued and resolved off the
  hot path, by :meth:`CompileCapture.drain` / :meth:`summary`; nothing
  on the dispatch path waits on them.  This is not the entry's kernel
  time: on a host-bound path the interval holds the stream's idle gaps
  while the host prepares the entry's next launch.  Kernel time comes
  from a ``torch.profiler`` trace.  A call made while a CUDA graph is
  captured is not timed, and a replayed graph calls no entry: where the
  serving engine replays graphs (``serving.query_engine``), only its
  eager calls are timed.

With a capture installed, the three kernel launch wrappers also add the
analytic cost of each launch (:func:`kernel_cost`, from shapes alone) to
``kernel_cost_ops_total{kernel=}`` and ``kernel_cost_bytes_total{kernel=}``;
each replay of a CUDA graph adds the costs of the launches it captured
(``kernels.launches``).

The port has no jit, so the reference's ``jit_*`` series, ``aot_cost`` and
``normalize_cost`` (XLA ``cost_analysis``) have no counterpart here.  This
module imports torch only inside the functions that need it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .locks import make_lock
from .metrics import MetricsRegistry, REGISTRY
from .timing import Stopwatch

# float32 operations per (segment, edge) pair of the visibility predicate
# once the segment's own terms (dx, dy, l2, tau, l2 - tau) and the edge's
# (bx - ax, by - ay) are hoisted (kernels/csrc/blocked_pairs.cuh): 6
# differences to the endpoints, 8 cross products, 4 banded signs at 3
# operations and 2 compares.  A pair whose edge end lies on the segment's
# line needs 14 more; exact contacts only, so the count leaves them out.
SEGVIS_OPS_PER_PAIR = 6 + 8 + 4 * 5
# a gathered tile slot is its own edge: the two edge differences too
TILE_OPS_PER_SLOT = SEGVIS_OPS_PER_PAIR + 2
# a gathered tile slot: six float32 planes (ax, ay, bx, by, cx, cy)
TILE_BYTES_PER_SLOT = 6 * 4
# the sorted row join per label: one min into its hub's run (t side), one
# add (s side); the searches that find a run are not counted
JOIN_OPS_PER_LABEL = 2

KERNELS = ("segvis", "segvis_tiles", "label_join_rowmin", "label_join")
# CUDA-event pairs queued for drain(); a timed call past this many is
# counted in CompileCapture.dropped instead
MAX_PENDING_TIMINGS = 1 << 16


def kernel_cost(name: str, shape: tuple, dist_bytes: int = 4) -> dict:
    """{"ops", "bytes"} of one launch of kernel ``name`` from its shape.

    Each input is read once and each output written once; the operations
    are every pair or slot of the shape (what the OR must evaluate when no
    segment is blocked early), the join's the sorted join's floor.

    * ``segvis`` (N, E): p, q [N, 2] and ea, eb, ec [E, 2] float32 in, [N]
      bool out; N·E pairs × :data:`SEGVIS_OPS_PER_PAIR`.
    * ``segvis_tiles`` (N, S): six [N, S] float32 planes and p, q in, [N]
      bool out; N·S slots × :data:`TILE_OPS_PER_SLOT`.
    * ``label_join_rowmin`` (B, L): int32 hubs and ``dist_bytes`` distances
      of both sides in, [B, L] float32 out (20·B·L bytes, 16·B·L with
      2-byte distances).
    * ``label_join`` (B, L): the same inputs, the [B] float32 row minima
      out; B·L more operations for the minimum.
    """
    if name == "segvis":
        n, e = shape
        return {"ops": SEGVIS_OPS_PER_PAIR * n * e,
                "bytes": 2 * n * 8 + 3 * e * 8 + n}
    if name == "segvis_tiles":
        n, s = shape
        return {"ops": TILE_OPS_PER_SLOT * n * s,
                "bytes": TILE_BYTES_PER_SLOT * n * s + 2 * n * 8 + n}
    if name in ("label_join_rowmin", "label_join"):
        b, l = shape
        read = 2 * b * l * 4 + 2 * b * l * dist_bytes
        if name == "label_join_rowmin":
            return {"ops": JOIN_OPS_PER_LABEL * b * l,
                    "bytes": read + b * l * 4}
        return {"ops": (JOIN_OPS_PER_LABEL + 1) * b * l,
                "bytes": read + b * 4}
    raise ValueError(f"no cost model for kernel {name!r} "
                     f"(known: {', '.join(KERNELS)})")


@dataclass
class CompileRecord:
    """One observed cold call of a serving entry."""

    entry: str
    compile_s: float
    output_bytes: float = 0.0


def _leaf_nbytes(out) -> float:
    """Output-byte count: sum ``.nbytes`` over result leaves (tensors and
    arrays in nested tuples, lists and dicts)."""
    total = 0.0
    stack = [out]
    while stack:
        x = stack.pop()
        if x is None:
            continue
        nb = getattr(x, "nbytes", None)
        if nb is not None:
            total += float(nb)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return total


def _on_card(args) -> bool:
    """True when the entry's first tensor argument (or the first tensor
    of its first tuple argument) lies on a CUDA device."""
    for a in args:
        if isinstance(a, (tuple, list)) and a:
            a = a[0]
        dev = getattr(a, "device", None)
        if dev is not None and getattr(dev, "type", None) is not None:
            return dev.type == "cuda"
    return False


def _capturing() -> bool:
    """True while the current CUDA stream captures a graph: an event
    recorded then would be a node of the graph, never a timing."""
    import torch

    return torch.cuda.is_current_stream_capturing()


class CompileCapture:
    """Routes profiled entry calls and attributes cold calls and costs.

    One instance is installed process-wide by :func:`enable_profile` (it
    becomes ``core.packed.TRACES.profiler``).  The cold detector reads
    the counter's *thread-local* count, so a background build thread
    meeting cold keys of its own never credits them to a foreground
    serving call.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 timing: bool = False, max_records: int = 512):
        self.registry = REGISTRY if registry is None else registry
        self.timing = bool(timing)
        self.records: List[CompileRecord] = []
        self.max_records = int(max_records)
        self.dropped = 0                # timed calls past the queue's room
        self.counter = None             # TraceCounter, bound by enable_profile
        self._pending: list = []        # (entry, start event, end event)
        self._stream_ms: Dict[str, List[float]] = {}
        self._lock = make_lock("obs.profile")

    # -- dispatcher hook (called from packed._serving_entry wrappers) -----

    def call(self, entry: str, fn, args, kw):
        c = self.counter
        before = -1 if c is None else c.thread_count()
        events = (self._events() if self.timing and _on_card(args)
                  and not _capturing() else None)
        with Stopwatch() as sw:
            if events is not None:
                events[0].record()
            out = fn(*args, **kw)
            if events is not None:
                events[1].record()
        if c is not None and c.thread_count() != before:
            self._record(entry, sw.seconds, out)
        if events is not None:
            with self._lock:
                if len(self._pending) < MAX_PENDING_TIMINGS:
                    self._pending.append((entry, *events))
                else:
                    self.dropped += 1
        return out

    @staticmethod
    def _events():
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def note_kernel(self, kernel: str, shape: tuple,
                    dist_bytes: int = 4) -> None:
        """Add one launch's analytic cost (:func:`kernel_cost`)."""
        cost = kernel_cost(kernel, shape, dist_bytes)
        self.registry.counter("kernel_cost_ops_total",
                              kernel=kernel).inc(cost["ops"])
        self.registry.counter("kernel_cost_bytes_total",
                              kernel=kernel).inc(cost["bytes"])

    # -- attribution ------------------------------------------------------

    def _record(self, entry: str, seconds: float, out) -> None:
        reg = self.registry
        reg.counter("entry_cold_seconds_total", entry=entry).inc(seconds)
        rec = CompileRecord(entry=entry, compile_s=float(seconds),
                            output_bytes=_leaf_nbytes(out))
        reg.counter("entry_cold_output_bytes_total",
                    entry=entry).inc(rec.output_bytes)
        with self._lock:
            if len(self.records) < self.max_records:
                self.records.append(rec)

    def drain(self) -> int:
        """Resolve the queued CUDA-event pairs into ``entry_stream_ms``
        (waits for each pair's end event: never call it on the dispatch
        path).  Returns the number of pairs resolved."""
        with self._lock:
            pending, self._pending = self._pending, []
        for entry, start, end in pending:
            end.synchronize()
            ms = start.elapsed_time(end)
            self.registry.histogram("entry_stream_ms",
                                    entry=entry).record(ms)
            with self._lock:
                self._stream_ms.setdefault(entry, []).append(ms)
        return len(pending)

    # -- readback ---------------------------------------------------------

    def by_entry(self) -> Dict[str, List[CompileRecord]]:
        with self._lock:
            recs = list(self.records)
        out: Dict[str, List[CompileRecord]] = {}
        for r in recs:
            out.setdefault(r.entry, []).append(r)
        return out

    def stream_ms(self) -> Dict[str, List[float]]:
        """Per-entry stream milliseconds resolved so far (after
        :meth:`drain`)."""
        with self._lock:
            return {k: list(v) for k, v in self._stream_ms.items()}

    def summary(self) -> dict:
        """Per-entry totals, JSON-ready; resolves queued timings first."""
        self.drain()
        dev = self.stream_ms()
        cold = self.by_entry()
        out = {}
        for entry in sorted(set(cold) | set(dev)):
            recs = cold.get(entry, [])
            ms = sorted(dev.get(entry, []))
            out[entry] = {
                "cold": len(recs),
                "cold_s": sum(r.compile_s for r in recs),
                "output_bytes": sum(r.output_bytes for r in recs),
                "stream_calls": len(ms),
                "stream_ms_median": ms[len(ms) // 2] if ms else None,
            }
        return out


_capture: Optional[CompileCapture] = None   # what note_kernel reads


def note_kernel(kernel: str, shape: tuple, dist_bytes: int = 4) -> None:
    """Kernel launch wrappers call this per launch: adds the launch's cost
    to the installed capture, nothing when none is installed."""
    cap = _capture
    if cap is not None:
        cap.note_kernel(kernel, shape, dist_bytes)


def enable_profile(registry: Optional[MetricsRegistry] = None,
                   timing: bool = False) -> CompileCapture:
    """Install a :class:`CompileCapture` on ``core.packed.TRACES`` (and for
    the kernel launch wrappers).  Returns the installed capture.

    Cold calls are attributed only for shape keys first met after this
    call: ``TRACES`` remembers every key of the process.
    """
    global _capture
    from repro_torch.core.packed import TRACES   # lazy: packed imports obs
    cap = CompileCapture(registry=registry, timing=timing)
    cap.counter = TRACES
    TRACES.profiler = cap
    _capture = cap
    return cap


def disable_profile() -> Optional[CompileCapture]:
    """Uninstall the active capture (returns it, or None)."""
    global _capture
    from repro_torch.core.packed import TRACES
    cap, TRACES.profiler = TRACES.profiler, None
    _capture = None
    return cap


class profiled:
    """Context manager: profile capture enabled inside the block."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 timing: bool = False):
        self._registry = registry
        self._timing = timing
        self.capture: Optional[CompileCapture] = None

    def __enter__(self) -> CompileCapture:
        self.capture = enable_profile(self._registry, timing=self._timing)
        return self.capture

    def __exit__(self, *exc) -> None:
        disable_profile()
