"""Named locks with a declared acquisition order (DESIGN.md §14).

The port's own copy of the reference's ``repro.obs.locks``, cut to what
:func:`make_lock` needs.  Every lock of the serving threads is made through
:func:`make_lock` under a name from :data:`LOCK_RANKS`; the names and ranks
are the reference's, so one static checker covers both packages.  With
``REPRO_LOCK_CHECK=1`` in the environment, :func:`make_lock` returns an
:class:`OrderedLock` that raises when a thread acquires a lock whose rank
is not above every rank it already holds.
"""

from __future__ import annotations

import os
import threading

#: name -> rank (lower = acquired first).  A subset of the reference's
#: table: the locks the port makes.
LOCK_RANKS: dict[str, int] = {
    "indexing.adapt": 10,       # IndexManager._adapt_lock (one rebuild)
    "batcher.queue": 20,        # CoalescingBatcher queue/condition
    "engine.swap": 30,          # SwappableEngine pin/swap pointer flip;
    #                             DeviceEngine CUDA graphs (copy-in, replay,
    #                             clone): engine locks, nested under none
    "batcher.ticket": 40,       # Ticket result scatter
    "workload.recorder": 50,    # WorkloadRecorder histogram
    "obs.profile": 55,          # CompileCapture records and event queue
    "obs.registry": 60,         # MetricsRegistry series creation
    "obs.series": 70,           # Counter/Gauge/Histogram mutation (leaf),
    #                             core.packed.TRACES
    "obs.events": 80,           # EventLog ring + JSONL sink (leaf)
    "obs.spans": 85,            # TraceLog ring (leaf)
    "obs.sampler": 90,          # HeadSampler accumulator (leaf)
}


def lock_check_enabled() -> bool:
    """True when the runtime lock-order check is requested."""
    return os.environ.get("REPRO_LOCK_CHECK", "") == "1"


class LockOrderError(RuntimeError):
    """A thread acquired locks against the declared order."""


class _HeldStack(threading.local):
    def __init__(self) -> None:
        self.stack: list[OrderedLock] = []


_HELD = _HeldStack()


class OrderedLock:
    """Lock that asserts the :data:`LOCK_RANKS` order when acquired.

    Usable as the lock behind a ``threading.Condition`` (``_is_owned`` is
    provided so the condition never probes ownership with a rank-checked
    ``acquire(0)``).
    """

    def __init__(self, name: str):
        if name not in LOCK_RANKS:
            raise KeyError(f"lock name {name!r} has no declared rank")
        self.name = name
        self.rank = LOCK_RANKS[name]
        self._lock = threading.Lock()
        self._owner: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _HELD.stack
        for h in held:
            if h.rank >= self.rank:
                raise LockOrderError(
                    f"lock-order violation: acquiring {self.name!r} (rank "
                    f"{self.rank}) while holding {h.name!r} (rank {h.rank})")
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            held.append(self)
        return got

    def release(self) -> None:
        self._owner = None
        stack = _HELD.stack
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: object) -> None:
        self.release()


def make_lock(name: str):
    """A ``threading.Lock``, or under ``REPRO_LOCK_CHECK=1`` an
    :class:`OrderedLock`; ``name`` must have a rank in :data:`LOCK_RANKS`."""
    if lock_check_enabled():
        return OrderedLock(name)
    if name not in LOCK_RANKS:
        raise KeyError(f"lock name {name!r} has no declared rank")
    return threading.Lock()


def held_locks() -> list[str]:
    """Names of OrderedLocks held by the calling thread (debug aid)."""
    return [h.name for h in _HELD.stack]
