"""Continuous-batching front end: coalescing queue + pipelined dispatch.

``PathServer.query`` answers one caller-assembled batch at a time, which
makes real-traffic throughput a batching problem: requests arrive one by
one, spread over dispatch keys (bucket widths), and a synchronous server
pays a full padded batch for every half-empty tail group.  The
:class:`CoalescingBatcher` turns the server into a continuous-batching loop
(DESIGN.md §6):

* **coalesce** — submitted queries enter per-dispatch-key groups.  A group
  ships when it fills ``batch_size`` (*full flush*) or when its oldest
  request has waited ``max_wait_ms`` (*deadline flush*); ``flush()``
  force-ships everything (*forced flush*).
* **pipeline** — the serve loop keeps up to ``depth`` (default 2) groups
  in flight: while group N computes on the device, group N+1 is staged
  (``QueryEngine.stage``, host-to-device copies) and dispatched
  (``QueryEngine.dispatch_staged``, no host synchronisation).  The loop
  waits on a group only when it retires it (``Pending.wait``).
* **backpressure** — ``max_queue`` bounds the queued queries; past it
  ``submit`` blocks (``policy="block"``) or raises :class:`QueueFull`
  (``policy="shed"``).
* **swap safety** — every group records the engine generation its routing
  keys were computed under.  Dispatch pins the engine
  (``QueryEngine.pin``); a group whose generation was superseded before
  dispatch is re-routed under the live generation (``requeued_batches``),
  and a group already in flight finishes on its pinned generation
  (``stale_batches``).

Results come back through :class:`Ticket` futures, scattered into the
submit order of each ticket whichever flush group answered them; the
server's workload recorder, when it has one, sees every retired query.
Admission, queue-depth and flush-reason counters land in the server's
``ServeStats``.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.packed import empty_results
from repro_torch.obs.locks import make_lock

if TYPE_CHECKING:             # import cycle: engine lazily imports us
    from repro_torch.serving.engine import PathServer


class QueueFull(RuntimeError):
    """Backpressure rejection (``policy="shed"`` and the queue is at
    ``max_queue``)."""


class Ticket:
    """Future for one ``submit()`` call (N queries, answered in order)."""

    def __init__(self, n: int, want_argmin: bool):
        self.n = n
        self.want_argmin = want_argmin
        self._outs = empty_results(n, want_argmin)
        self._remaining = n
        self._lock = make_lock("batcher.ticket")
        self._event = threading.Event()
        if n == 0:
            self._event.set()

    def _write(self, slots: np.ndarray, cols: list) -> None:
        for o, c in zip(self._outs, cols):
            o[slots] = c
        with self._lock:
            self._remaining -= len(slots)
            done = self._remaining == 0
        if done:
            self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        """Block until answered; [N] distances (or the 5-tuple of argmin
        outputs) in submit order."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket incomplete ({self._remaining} of "
                               f"{self.n} queries pending)")
        return tuple(self._outs) if self.want_argmin else self._outs[0]


class _Entry:
    """One queued query: destination ticket slot, endpoints, arrival time
    and the number of swap-superseded re-routes it went through."""

    __slots__ = ("ticket", "slot", "s", "t", "arrived", "requeues")

    def __init__(self, ticket, slot, s, t, arrived):
        self.ticket = ticket
        self.slot = slot
        self.s = s
        self.t = t
        self.arrived = arrived
        self.requeues = 0


class _Flight:
    """A dispatched group awaiting retirement.  Carries its own
    ``BucketStats`` row: a generation reset between launch and retire
    replaces ``stats.per_bucket``, and retiring into the new generation's
    row would count queries against slots it never dispatched."""

    __slots__ = ("pin_cm", "eng", "gen", "key", "entries", "res",
                 "t_launch", "bstats")

    def __init__(self, pin_cm, eng, gen, key, entries, res, t_launch,
                 bstats):
        self.pin_cm = pin_cm
        self.eng = eng
        self.gen = gen
        self.key = key
        self.entries = entries
        self.res = res
        self.t_launch = t_launch
        self.bstats = bstats


class CoalescingBatcher:
    """Coalescing queue + pipelined dispatch over a PathServer.

    ``server``: the :class:`~repro_torch.serving.engine.PathServer` whose
    engine, ``batch_size`` and ``stats`` this loop serves through.  One
    batcher per server; made by ``PathServer.start_async()``.
    """

    def __init__(self, server: "PathServer", max_wait_ms: float = 2.0,
                 max_queue: int = 8192, policy: str = "block",
                 depth: int = 2, autostart: bool = True):
        if policy not in ("block", "shed"):
            raise ValueError(f"policy must be block|shed, got {policy!r}")
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.server = server
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self.policy = policy
        self.depth = int(depth)
        # (generation, routing key, want_argmin) -> FIFO entry list
        self._groups: dict[tuple, list] = {}
        self._queued = 0            # entries waiting in groups
        self._in_flight = 0         # entries staged/dispatched, not retired
        self._force = False         # flush() latch: ship everything queued
        self._closing = False
        self._lock = make_lock("batcher.queue")
        self._cond = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        if autostart:
            self.start()

    # -------------------------------------------------------------- control
    def start(self) -> None:
        """Start the serve loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="pathserver-batcher",
                                        daemon=True)
        self._thread.start()

    def flush(self) -> None:
        """Force every queued group to dispatch without waiting for the
        batch to fill or the deadline to expire."""
        with self._cond:
            self._force = True
            self._cond.notify_all()

    def drain(self, timeout: float | None = None) -> bool:
        """Flush, then block until the queue and the pipeline are empty."""
        self.flush()
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            while self._queued or self._in_flight:
                left = None if deadline is None \
                    else max(0.0, deadline - time.perf_counter())
                if left == 0.0:
                    return False
                self._cond.wait(timeout=0.02 if left is None
                                else min(0.02, left))
        return True

    def close(self, drain: bool = True) -> None:
        """Stop the serve loop; ``drain=True`` answers everything queued
        first, ``drain=False`` abandons queued work (tickets stay pending)."""
        if drain and self._thread is not None and self._thread.is_alive():
            self.drain()
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queued

    # --------------------------------------------------------------- submit
    def submit(self, s, t, want_argmin: bool = False) -> Ticket:
        """Enqueue N queries; returns a :class:`Ticket` future.

        Routing keys are computed on the host against the engine generation
        current at admission; the dispatch path revalidates them.  Blocks
        (or sheds) when the backpressure gate is closed.
        """
        s = np.ascontiguousarray(np.asarray(s, np.float32)).reshape(-1, 2)
        t = np.ascontiguousarray(np.asarray(t, np.float32)).reshape(-1, 2)
        n = len(s)
        ticket = Ticket(n, want_argmin)
        if n == 0:
            return ticket
        stats = self.server.stats
        with self.server.engine.pin() as eng:
            gen = eng.generation
            keys = eng.buckets_of(s, t)
        now = time.perf_counter()
        with self._cond:
            if self._closing:
                raise RuntimeError("batcher is closed")
            if self._queued + n > self.max_queue:
                if self.policy == "shed":
                    stats.shed += n
                    raise QueueFull(
                        f"queue at {self._queued}/{self.max_queue}; "
                        f"rejected {n} queries")
                stats.admission_waits += 1
                # a submit larger than max_queue can never fit beside other
                # work; it admits alone once the queue is empty
                while self._queued + n > self.max_queue and self._queued \
                        and not self._closing:
                    self._cond.wait(timeout=0.02)
                if self._closing:
                    raise RuntimeError("batcher closed while blocked on "
                                       "the admission gate")
            for i in range(n):
                k = int(keys[i])
                self._groups.setdefault((gen, k, want_argmin), []).append(
                    _Entry(ticket, i, s[i], t[i], now))
                self.server._bucket_stats(k, eng).admitted += 1
            self._queued += n
            stats.submitted += n
            stats.queue_depth = self._queued
            stats.queue_depth_peak = max(stats.queue_depth_peak,
                                         self._queued)
            self._cond.notify_all()
        return ticket

    # ----------------------------------------------------------- serve loop
    def _serve_loop(self) -> None:
        inflight: collections.deque[_Flight] = collections.deque()
        stats = self.server.stats
        while True:
            launched = False
            while len(inflight) < self.depth:
                chunk = self._pop_ready(block=not (inflight or launched))
                if chunk is None:
                    break
                flight = self._launch(*chunk)
                if flight is not None:
                    inflight.append(flight)
                    launched = True
                    stats.pipeline_peak = max(stats.pipeline_peak,
                                              len(inflight))
            if inflight:
                self._retire(inflight.popleft())
            elif self._done():
                return

    def _done(self) -> bool:
        with self._lock:
            return self._closing and not self._queued

    def _pop_ready(self, block: bool):
        """Next dispatchable (gen, key, want_argmin, entries, reason)
        chunk, or None.  ``block=True`` waits (deadline-aware) until one
        exists or the batcher is closing with an empty queue."""
        bs = self.server.batch_size
        stats = self.server.stats
        with self._cond:
            while True:
                best, reason = None, ""
                now = time.perf_counter()
                for gk, entries in self._groups.items():
                    if not entries:
                        continue
                    if len(entries) >= bs:
                        r = "full"
                    elif self._force or self._closing:
                        r = "forced"
                    elif now - entries[0].arrived >= self.max_wait_s:
                        r = "deadline"
                    else:
                        continue
                    if best is None or entries[0].arrived \
                            < self._groups[best][0].arrived:
                        best, reason = gk, r
                if best is not None:
                    entries = self._groups[best]
                    chunk, rest = entries[:bs], entries[bs:]
                    if rest:
                        self._groups[best] = rest
                    else:
                        del self._groups[best]
                        if not any(self._groups.values()):
                            self._force = False
                    self._queued -= len(chunk)
                    stats.queue_depth = self._queued
                    if reason == "full":
                        stats.full_flushes += 1
                    elif reason == "deadline":
                        stats.deadline_flushes += 1
                    else:
                        stats.forced_flushes += 1
                    self._in_flight += len(chunk)
                    self._cond.notify_all()     # admission gate may reopen
                    gen, key, want_argmin = best
                    return gen, key, want_argmin, chunk, reason
                if not block or (self._closing and not self._queued):
                    return None
                self._cond.wait(timeout=self._wait_timeout(now))

    def _wait_timeout(self, now: float) -> float:
        """Sleep until the nearest group deadline (bounded poll)."""
        nearest = None
        for entries in self._groups.values():
            if entries:
                d = entries[0].arrived + self.max_wait_s - now
                nearest = d if nearest is None else min(nearest, d)
        if nearest is None:
            return 0.05
        return float(min(0.05, max(1e-4, nearest)))

    # ------------------------------------------------------------- dispatch
    def _launch(self, gen: int, key: int, want_argmin: bool,
                entries: list, reason: str) -> _Flight | None:
        """Stage + dispatch one chunk under a pinned engine.

        Returns the in-flight handle, or None when the chunk's generation
        was superseded before dispatch — its entries are re-routed under
        the live generation (a *requeue*, not a dispatch: no per-bucket
        batch or slot accounting happens).
        """
        srv = self.server
        stats = srv.stats
        cm = srv.engine.pin()
        eng = cm.__enter__()
        if eng.generation != gen:
            cm.__exit__(None, None, None)
            self._requeue(entries, want_argmin)
            return None
        if eng.generation != stats.generation:
            # first dispatch of a new generation: per-bucket rows describe
            # the previous artifact's routing, so they restart
            stats.swaps += max(0, eng.generation - stats.generation)
            stats.per_bucket = {}
            stats.generation = eng.generation
        n = len(entries)
        rows = srv.batch_size if getattr(eng, "static_shapes", True) else n
        sb = np.zeros((rows, 2), np.float32)
        tb = np.zeros((rows, 2), np.float32)
        for i, e in enumerate(entries):
            sb[i] = e.s
            tb[i] = e.t
        t0 = time.perf_counter()
        staged = eng.stage(sb, tb, bucket=key)
        res = eng.dispatch_staged(staged, bucket=key,
                                  want_argmin=want_argmin)
        bstats = srv._bucket_stats(key, eng)
        bstats.batches += 1
        bstats.slots += rows
        if reason == "full":
            bstats.full_flushes += 1
        elif reason == "deadline":
            bstats.deadline_flushes += 1
        stats.batches += 1
        return _Flight(cm, eng, gen, key, entries, res, t0, bstats)

    def _requeue(self, entries: list, want_argmin: bool) -> None:
        """Re-route a superseded chunk: recompute keys under the live
        generation and put the entries back with their original arrival
        times (deadlines keep counting from first admission)."""
        srv = self.server
        s = np.stack([e.s for e in entries])
        t = np.stack([e.t for e in entries])
        with srv.engine.pin() as eng:
            gen = eng.generation
            keys = eng.buckets_of(s, t)
        with self._cond:
            for e, k in zip(entries, keys):
                e.requeues += 1
                self._groups.setdefault((gen, int(k), want_argmin),
                                        []).append(e)
            self._queued += len(entries)
            self._in_flight -= len(entries)
            srv.stats.requeued_batches += 1
            srv.stats.queue_depth = self._queued
            self._cond.notify_all()

    def _retire(self, f: _Flight) -> None:
        """Wait for one in-flight group, scatter its results into tickets,
        close out stats, release the generation pin."""
        srv = self.server
        stats = srv.stats
        try:
            outs = f.res.wait()
            dt = time.perf_counter() - f.t_launch
            n = len(f.entries)
            outs = [o[:n] for o in outs]
            # per-shard attribution of a sharded engine (its home shard's
            # seconds), before the tickets complete
            note = getattr(f.eng, "note_batch_seconds", None)
            if note is not None:
                note(f.key, dt)
            shard_stats = getattr(f.eng, "shard_stats", None)
            if shard_stats is not None:
                stats.per_shard = shard_stats()
            if srv._recorder is not None:
                # recorded before the tickets complete, so a caller that
                # holds its results also sees them in the workload
                srv._recorder.record(np.stack([e.s for e in f.entries]),
                                     np.stack([e.t for e in f.entries]))
            per_ticket: dict = collections.defaultdict(lambda: ([], []))
            for bi, e in enumerate(f.entries):
                rows, slots = per_ticket[e.ticket]
                rows.append(bi)
                slots.append(e.slot)
            for ticket, (rows, slots) in per_ticket.items():
                ridx = np.asarray(rows)
                ticket._write(np.asarray(slots), [o[ridx] for o in outs])
            f.bstats.queries += n
            f.bstats.seconds += dt
            stats.queries += n
            stats.seconds += dt
            if srv.engine.generation != f.gen:
                # a swap published while this group was in flight: it
                # finished on its pinned (now superseded) artifact
                stats.stale_batches += 1
        finally:
            f.pin_cm.__exit__(None, None, None)
            with self._cond:
                self._in_flight -= len(f.entries)
                self._cond.notify_all()
