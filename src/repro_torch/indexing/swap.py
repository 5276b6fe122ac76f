"""Zero-downtime engine hot-swap — generation-counted double buffering.

:class:`SwappableEngine` is a
:class:`~repro_torch.serving.query_engine.QueryEngine` that delegates to a
*current* engine and can atomically replace it while requests are in
flight:

* ``pin()`` (used by ``PathServer._dispatch`` and the batcher) hands out
  the current (generation, engine) pair under a lock and refcounts it —
  every call of a multi-call request (bucket routing + batches) resolves
  against one consistent artifact;
* ``swap(new_engine)`` publishes the replacement and bumps the generation;
  requests pinned to the old generation finish on the old artifact, which is
  retired and **dropped only when its last pin drains** — that release is
  what frees the superseded index's device buffers;
* unpinned single calls (``batch``/``buckets_of`` outside ``pin``) always
  see the latest engine;
* the split-phase pair (``stage``/``dispatch_staged``) is refused on the
  swappable itself: a staged batch holds one generation's pinned slot and
  device endpoints, which only that generation's engine may dispatch.  The
  continuous batcher stages and dispatches through the engine ``pin()``
  yields, and keeps the pin until the batch retires.

No request ever waits on a swap and no swap ever waits on a request longer
than the lock's pointer flip — zero downtime by construction.
"""

from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.obs.locks import make_lock
from repro_torch.serving.query_engine import QueryEngine


class SwappableEngine(QueryEngine):
    """Engine indirection with atomic generation-counted replacement."""

    name = "swappable"

    def __init__(self, engine: QueryEngine):
        self._lock = make_lock("engine.swap")
        self._current = engine
        engine.generation = 0   # each wrapped engine is 1:1 with its
        self._gen = 0           # generation (stamped here and in swap())
        self._pins: dict[int, int] = {}        # generation -> active pins
        self._retired: dict[int, QueryEngine] = {}
        self.swaps = 0
        self.drops = 0          # superseded artifacts fully drained + freed

    # ----------------------------------------------------------- properties
    @property
    def generation(self) -> int:
        return self._gen

    @property
    def current(self) -> QueryEngine:
        return self._current

    @property
    def artifact(self):
        """The current engine's packed index (None for host engines)."""
        return getattr(self._current, "index", None)

    @property
    def static_shapes(self) -> bool:
        return self._current.static_shapes

    @property
    def num_buckets(self) -> int:
        return self._current.num_buckets

    @property
    def use_kernels(self) -> bool:
        return getattr(self._current, "use_kernels", False)

    # ------------------------------------------------------------- pinning
    @contextlib.contextmanager
    def pin(self):
        with self._lock:
            gen, eng = self._gen, self._current
            self._pins[gen] = self._pins.get(gen, 0) + 1
        try:
            yield eng
        finally:
            self._release(gen)

    def _release(self, gen: int) -> None:
        with self._lock:
            self._pins[gen] -= 1
            if self._pins[gen] == 0:
                del self._pins[gen]
                if self._retired.pop(gen, None) is not None:
                    self.drops += 1     # last ref gone -> device buffers free

    def retired_generations(self) -> list:
        """Generations superseded but still pinned by in-flight requests."""
        with self._lock:
            return sorted(self._retired)

    # --------------------------------------------------------------- swap
    def swap(self, new_engine: QueryEngine) -> int:
        """Publish ``new_engine`` atomically; returns the new generation.

        The superseded engine is dropped immediately if nothing is pinned to
        it, otherwise parked until its pins drain.
        """
        with self._lock:
            old, old_gen = self._current, self._gen
            new_engine.generation = old_gen + 1   # see pin(): a request
            self._current = new_engine            # reads the generation it
            self._gen = old_gen + 1               # actually pinned
            self.swaps += 1
            if self._pins.get(old_gen):
                self._retired[old_gen] = old
            else:
                self.drops += 1
        return self._gen

    # ------------------------------------------------- QueryEngine protocol
    def buckets_of(self, s, t) -> np.ndarray:
        return self._current.buckets_of(s, t)

    def bucket_width(self, bucket: int) -> int:
        return getattr(self._current, "bucket_width", lambda b: 0)(bucket)

    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        return self._current.batch(s, t, bucket=bucket)

    def batch_argmin(self, s, t, bucket: int = 0):
        return self._current.batch_argmin(s, t, bucket=bucket)

    def stage(self, s, t, bucket: int = 0):
        raise TypeError("stage a batch on the engine pin() yields: a staged "
                        "batch belongs to one generation")

    def dispatch_staged(self, staged, bucket: int = 0,
                        want_argmin: bool = False):
        raise TypeError("dispatch a staged batch on the engine that staged "
                        "it (the one pin() yields)")

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        self._current.warmup(batch_size, want_argmin=want_argmin)

    def device_bytes(self) -> int:
        """Bytes of the *current* artifact (retired ones are draining)."""
        return self._current.device_bytes()

    def __getattr__(self, name):
        """Delegate engine-specific surface (e.g. the sharded engine's
        ``shard_stats``/``per_shard_bytes``/``query``) to the current
        engine.  Unpinned like ``batch`` — multi-call consistency goes
        through ``pin()``.

        ``index`` is deliberately NOT delegated: long-lived holders would
        capture one generation's artifact and keep its device buffers alive
        across every future swap, defeating the drop-after-drain release.
        ``artifact`` is the sanctioned (momentary) accessor.
        """
        if name.startswith("_") or name == "index":
            raise AttributeError(name)
        return getattr(self._current, name)
