"""Batched request serving — the paper's online phase as a serving loop.

``PathServer`` fronts a pluggable :class:`~repro_torch.serving.query_engine.
QueryEngine`: requests are routed by dispatch bucket (max of the two
endpoint-region buckets under the width-bucketed layout, DESIGN.md §4),
each bucket group is cut into fixed-size batches (zero-padding the tail
keeps the kernels' shapes steady), answered, and scattered back into
request order.  Per-bucket latency/occupancy counters make the routing
observable.  ``start_async``/``submit``/``flush``/``drain``/``stop_async``
front the same engine with the continuous batcher (``serving.batcher``).
A ``recorder`` (``indexing.WorkloadRecorder``) is fed every answered
query, synchronous or through the batcher, for adaptive re-indexing.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.packed import empty_results
from repro_torch.core.query import path_length, unwind_path
from repro_torch.serving.query_engine import HostEngine, QueryEngine, make_engine


@dataclasses.dataclass
class BucketStats:
    """Per-dispatch-bucket serving counters (width = label slots paid)."""

    width: int = 0
    batches: int = 0
    queries: int = 0
    seconds: float = 0.0
    slots: int = 0          # batch slots dispatched (incl. tail padding)
    # continuous batching: admission + flush mix
    admitted: int = 0
    full_flushes: int = 0
    deadline_flushes: int = 0

    @property
    def occupancy(self) -> float:
        """Real queries / dispatched slots (1.0 = no tail padding waste)."""
        return self.queries / max(1, self.slots)

    @property
    def us_per_query(self) -> float:
        return 1e6 * self.seconds / max(1, self.queries)


@dataclasses.dataclass
class ServeStats:
    """Server-level counters."""

    batches: int = 0
    queries: int = 0
    seconds: float = 0.0
    per_bucket: dict = dataclasses.field(default_factory=dict)
    # generation changes observed / batches finished on a superseded one;
    # per_bucket restarts whenever a new generation is first served
    swaps: int = 0
    stale_batches: int = 0
    generation: int = 0
    # continuous batching (serving.batcher): admission, queue, flush mix
    submitted: int = 0
    shed: int = 0
    admission_waits: int = 0
    full_flushes: int = 0
    deadline_flushes: int = 0
    forced_flushes: int = 0
    requeued_batches: int = 0
    queue_depth: int = 0
    queue_depth_peak: int = 0
    pipeline_peak: int = 0
    # sharded serving (repro_torch.sharding): the engine's per-shard
    # ShardStats rows, refreshed after every request and retired batch
    per_shard: list = dataclasses.field(default_factory=list)

    @property
    def us_per_query(self) -> float:
        return 1e6 * self.seconds / max(1, self.queries)

    @property
    def qps(self) -> float:
        return self.queries / max(1e-9, self.seconds)


def expected_join_cost(engine, s, t) -> float:
    """Expected per-query join cost on a workload: mean dispatch-width^2.

    The O(W^2) label join is what a query pays at its dispatch width; a
    workload-aware index keeps hot regions in narrow buckets, so this is
    the metric the adaptive demo compares against the uniform-score index
    (smaller = cheaper hot path).  Host arithmetic on the routing only.
    """
    buckets = engine.buckets_of(s, t)
    widths = np.array([engine.bucket_width(int(k)) for k in buckets])
    return float(np.mean(widths.astype(np.float64) ** 2))


class PathServer:
    """Fixed-batch ESPP query server over a pluggable query engine.

    ``index`` may be a ready-made :class:`QueryEngine`, a packed
    PackedIndex or BucketedIndex, or a host EHLIndex (packed bucketed onto
    ``device``); all but the first are wrapped in a ``backend`` engine
    (``make_engine``).  ``recorder``: a workload recorder (``record(s, t)``)
    that every answered query is folded into.
    """

    def __init__(self, index, batch_size: int = 256, backend: str = "cuda",
                 device="cuda", recorder=None):
        if isinstance(index, QueryEngine):
            self.engine = index
        else:
            self.engine = make_engine(index, backend=backend, device=device)
        self.batch_size = batch_size
        self.stats = ServeStats()
        self._recorder = recorder
        self._batcher = None        # continuous batching: start_async()

    def warmup(self, paths: bool = False):
        """Run every bucket width once at the serving batch shape (and, with
        ``paths=True``, the argmin path behind ``query_paths``), so the first
        live request never pays a kernel build or load, a new allocator
        shape or a staging buffer (checked by ``core.packed.TRACES``)."""
        self.engine.warmup(self.batch_size, want_argmin=paths)

    # -------------------------------------------------- continuous batching
    def start_async(self, max_wait_ms: float = 2.0, max_queue: int = 8192,
                    policy: str = "block", depth: int = 2):
        """Start the continuous-batching serve loop (``serving.batcher``);
        returns the :class:`~repro_torch.serving.batcher.CoalescingBatcher`
        that ``submit``/``flush``/``drain``/``stop_async`` delegate to."""
        from repro_torch.serving.batcher import CoalescingBatcher

        if self._batcher is not None:
            raise RuntimeError("async serve loop already running; "
                               "stop_async() first")
        self._batcher = CoalescingBatcher(self, max_wait_ms=max_wait_ms,
                                          max_queue=max_queue,
                                          policy=policy, depth=depth)
        return self._batcher

    def submit(self, s, t, want_argmin: bool = False):
        """Enqueue N requests on the coalescing queue; returns a
        :class:`~repro_torch.serving.batcher.Ticket` (results in submit
        order).  Starts the serve loop with defaults if needed."""
        if self._batcher is None:
            self.start_async()
        return self._batcher.submit(s, t, want_argmin=want_argmin)

    def flush(self) -> None:
        """Force every queued group to dispatch now."""
        if self._batcher is not None:
            self._batcher.flush()

    def drain(self, timeout: float | None = None) -> bool:
        """Flush, then wait until the queue and the pipeline are empty."""
        if self._batcher is None:
            return True
        return self._batcher.drain(timeout=timeout)

    def stop_async(self) -> None:
        """Drain and stop the serve loop (``submit`` may start a new one)."""
        if self._batcher is not None:
            self._batcher.close(drain=True)
            self._batcher = None

    def _bucket_stats(self, bucket: int, eng=None) -> BucketStats:
        if bucket not in self.stats.per_bucket:
            eng = self.engine if eng is None else eng
            self.stats.per_bucket[bucket] = BucketStats(
                width=eng.bucket_width(bucket))
        return self.stats.per_bucket[bucket]

    def _dispatch(self, s, t, want_argmin: bool):
        """Bucket-route N requests through fixed-shape batches; scatter back.

        Sort by dispatch bucket, answer each bucket's sub-batches at that
        bucket's width, write results back through the permutation.
        Returns a list of [N]-arrays (1 for distances, 5 for argmin).  The
        engine is pinned for the whole request, so routing and every batch
        resolve against one artifact generation.
        """
        n = len(s)
        bs = self.batch_size
        b0 = self.stats.batches
        with self.engine.pin() as eng:
            gen0 = eng.generation
            if gen0 != self.stats.generation:
                # a new artifact: per-bucket rows describe the old routing
                self.stats.swaps += max(0, gen0 - self.stats.generation)
                self.stats.per_bucket = {}
            pad = eng.static_shapes
            buckets = eng.buckets_of(s, t) if n else np.zeros(0, np.int32)
            outs = empty_results(n, want_argmin)
            for k in np.unique(buckets):
                idxs = np.nonzero(buckets == k)[0]
                bstats = self._bucket_stats(int(k), eng)
                tb0 = time.perf_counter()
                for lo in range(0, len(idxs), bs):
                    sel = idxs[lo:lo + bs]
                    # device engines get fixed [bs, 2] shapes; the host
                    # oracle takes the ragged tail
                    rows = bs if pad else len(sel)
                    sb = np.zeros((rows, 2), np.float32)
                    tb = np.zeros((rows, 2), np.float32)
                    sb[:len(sel)] = s[sel]
                    tb[:len(sel)] = t[sel]
                    if want_argmin:
                        res = eng.batch_argmin(sb, tb, bucket=int(k))
                    else:
                        res = (eng.batch(sb, tb, bucket=int(k)),)
                    for o, r in zip(outs, res):
                        o[sel] = r[:len(sel)]
                    bstats.batches += 1
                    bstats.slots += rows
                    self.stats.batches += 1
                bstats.queries += len(idxs)
                bstats.seconds += time.perf_counter() - tb0
            shard_stats = getattr(eng, "shard_stats", None)
            if shard_stats is not None:
                self.stats.per_shard = shard_stats()
        if self.engine.generation != gen0:
            # a swap published while this request served on the old pin
            self.stats.stale_batches += self.stats.batches - b0
        self.stats.generation = gen0
        if self._recorder is not None and n:
            self._recorder.record(s, t)
        return outs

    def query(self, s: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Answer N distance requests (any N), bucket-routed."""
        t0 = time.perf_counter()
        out = self._dispatch(np.asarray(s, np.float32),
                             np.asarray(t, np.float32), want_argmin=False)[0]
        self.stats.seconds += time.perf_counter() - t0
        self.stats.queries += len(out)
        return out

    def query_paths(self, s: np.ndarray, t: np.ndarray, host_index=None
                    ) -> tuple[np.ndarray, list]:
        """Distances + optimal polylines for N requests.

        The batched argmin engine identifies each query's winning
        (via_s, hub, via_t) triple; unwinding follows the hub labels'
        next-hop pointers, which live host-side — pass the host
        ``EHLIndex`` (defaults to a HostEngine's own index).
        """
        s = np.asarray(s, np.float32)
        t = np.asarray(t, np.float32)
        t0 = time.perf_counter()
        if isinstance(self.engine, HostEngine):
            paths = self.engine.paths(s, t)
            d = np.array([path_length(p) for p in paths], dtype=np.float32)
            if self._recorder is not None and len(s):
                self._recorder.record(s, t)
        else:
            if host_index is None:
                raise ValueError("query_paths on a device engine needs the "
                                 "host EHLIndex for label unwinding")
            d, covis, via_s, hub, via_t = self._dispatch(s, t,
                                                         want_argmin=True)
            paths = []
            for i in range(len(s)):
                if covis[i]:
                    paths.append([s[i].astype(np.float64),
                                  t[i].astype(np.float64)])
                elif not np.isfinite(d[i]):
                    paths.append([])
                else:
                    paths.append(unwind_path(host_index, s[i], t[i],
                                             int(via_s[i]), int(hub[i]),
                                             int(via_t[i])))
        self.stats.seconds += time.perf_counter() - t0
        self.stats.queries += len(s)
        return d, paths
