"""The port's continuous batcher: coalescing, flush reasons, backpressure,
swap safety, and async answers against the synchronous path (CPU).

The cases of the reference's ``tests/test_batcher.py``, driven through the
port's :class:`~repro_torch.serving.batcher.CoalescingBatcher`: most go
through a deterministic keyed fake engine (no device work, no timing
flakiness); the two swap cases use a test-local hot-swapping double whose
``pin()`` yields the live generation's engine; the identity tests at the
bottom go through a real ``TorchEngine`` against ``PathServer``'s
synchronous path, bit for bit.  Every wait has a timeout.
"""

import contextlib
import importlib.util
import pathlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.packed import pack_bucketed
from repro_torch.core.visgraph import build_visgraph
from repro_torch.core.workload import uniform_queries
from repro_torch.serving import PathServer, QueryEngine, TorchEngine
from repro_torch.serving.batcher import CoalescingBatcher, QueueFull


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _KeyedEngine(QueryEngine):
    """Deterministic 4-key engine: answer = s.x + 1000 * val.

    Routing depends only on the query (floor of s.x mod 4), so expected
    answers are computable without the engine — coalescing/scatter bugs
    show up as wrong values, not just wrong stats.
    """

    name = "keyed"
    static_shapes = True
    num_buckets = 4

    def __init__(self, val: float = 0.0):
        self.val = val
        self.dispatched = []        # (bucket, rows) per batch() call

    def buckets_of(self, s, t):
        return (np.asarray(s)[:, 0].astype(np.int64) % 4).astype(np.int32)

    def bucket_width(self, bucket: int) -> int:
        return 128

    def batch(self, s, t, bucket: int = 0):
        self.dispatched.append((bucket, len(s)))
        return (np.asarray(s)[:, 0] + 1000.0 * self.val).astype(np.float32)

    def batch_argmin(self, s, t, bucket: int = 0):
        d = self.batch(s, t, bucket)
        z = np.zeros(len(d), np.int32)
        return d, z, z, z, z


class _SwapDouble(QueryEngine):
    """Hot-swapping engine double: ``pin()`` yields the engine of the live
    generation, ``swap`` publishes the next one and stamps its number."""

    name = "swap-double"
    static_shapes = True

    def __init__(self, engine):
        engine.generation = 0
        self.live = engine

    @property
    def generation(self) -> int:
        return self.live.generation

    def swap(self, engine) -> None:
        engine.generation = self.live.generation + 1
        self.live = engine

    @contextlib.contextmanager
    def pin(self):
        yield self.live

    def buckets_of(self, s, t):
        return self.live.buckets_of(s, t)

    def bucket_width(self, bucket: int) -> int:
        return self.live.bucket_width(bucket)

    def batch(self, s, t, bucket: int = 0):
        return self.live.batch(s, t, bucket)


def _mk(val=0.0, batch_size=8, **kw):
    srv = PathServer(_KeyedEngine(val), batch_size=batch_size)
    kw.setdefault("autostart", False)
    return srv, CoalescingBatcher(srv, **kw)


def _pts(xs):
    xs = np.asarray(xs, np.float32)
    return np.stack([xs, np.zeros_like(xs)], axis=1)


def _expect(xs, val=0.0):
    return np.asarray(xs, np.float32) + np.float32(1000.0 * val)


# ------------------------------------------------------------ flush reasons

def test_full_batch_flush_and_identity():
    srv, b = _mk(batch_size=8)
    xs = np.full(8, 4.0) + np.arange(8) * 4      # all key 0, fills exactly
    tk = b.submit(_pts(xs), _pts(xs))
    b.start()
    out = tk.result(timeout=10)
    b.close()
    np.testing.assert_array_equal(out, _expect(xs))
    assert srv.stats.full_flushes == 1
    assert srv.stats.deadline_flushes == 0
    assert srv.stats.per_bucket[0].full_flushes == 1
    assert srv.stats.per_bucket[0].slots == 8
    assert srv.stats.per_bucket[0].occupancy == 1.0


def test_deadline_flush_ships_partial_group():
    srv, b = _mk(batch_size=8, max_wait_ms=5.0, autostart=True)
    xs = np.array([4.0, 8.0, 12.0])              # key 0, under batch_size
    t0 = time.perf_counter()
    tk = b.submit(_pts(xs), _pts(xs))
    out = tk.result(timeout=10)                  # only the deadline ships it
    waited = time.perf_counter() - t0
    b.close()
    np.testing.assert_array_equal(out, _expect(xs))
    assert waited >= 0.004                       # not shipped early
    assert srv.stats.deadline_flushes == 1
    assert srv.stats.full_flushes == 0
    assert srv.stats.per_bucket[0].deadline_flushes == 1


def test_forced_flush_overrides_deadline():
    srv, b = _mk(batch_size=8, max_wait_ms=60_000.0, autostart=True)
    tk = b.submit(_pts([4.0]), _pts([4.0]))
    b.flush()
    out = tk.result(timeout=10)                  # long before the deadline
    b.close()
    np.testing.assert_array_equal(out, _expect([4.0]))
    assert srv.stats.forced_flushes == 1
    assert srv.stats.deadline_flushes == 0


def test_mixed_keys_coalesce_across_submits():
    """Interleaved keys from many submits regroup into per-key full batches
    and scatter back to each ticket in submit order."""
    srv, b = _mk(batch_size=8)
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 64, size=48).astype(np.float32)   # keys 0..3 mixed
    tickets = [b.submit(_pts(xs[i:i + 3]), _pts(xs[i:i + 3]))
               for i in range(0, 48, 3)]
    b.start()
    b.flush()
    assert b.drain(timeout=10)
    b.close()
    for i, tk in enumerate(tickets):
        np.testing.assert_array_equal(tk.result(timeout=1),
                                      _expect(xs[3 * i:3 * i + 3]))
    eng = srv.engine
    # coalescing: every dispatched batch holds a single key's queries
    keys = (np.asarray(xs).astype(np.int64) % 4)
    per_key = {k: int((keys == k).sum()) for k in range(4)}
    batches = sum(-(-n // 8) for n in per_key.values())
    assert len(eng.dispatched) == batches
    for k, bstats in srv.stats.per_bucket.items():
        assert bstats.admitted == per_key[k]
        assert bstats.queries == per_key[k]
        assert bstats.occupancy <= 1.0


def test_argmin_tickets_round_trip():
    srv, b = _mk(batch_size=8)
    xs = np.array([4.0, 5.0, 6.0])
    tk = b.submit(_pts(xs), _pts(xs), want_argmin=True)
    b.start()
    b.flush()
    out = tk.result(timeout=10)
    b.close()
    assert len(out) == 5
    np.testing.assert_array_equal(out[0], _expect(xs))
    # distance-only and argmin groups must not share a dispatch even on
    # the same routing key
    assert srv.stats.batches == 3       # keys 0,1,2 x one argmin group each


# ------------------------------------------------------------- backpressure

def test_backpressure_shed_raises_queue_full():
    srv, b = _mk(batch_size=8, max_queue=4, policy="shed")
    b.submit(_pts([0.0, 1.0]), _pts([0.0, 1.0]))
    with pytest.raises(QueueFull):
        b.submit(_pts([2.0, 3.0, 4.0]), _pts([2.0, 3.0, 4.0]))
    assert srv.stats.shed == 3
    assert srv.stats.submitted == 2          # rejected queries not admitted
    assert b.queue_depth == 2


def test_backpressure_block_waits_for_drain():
    srv, b = _mk(batch_size=4, max_queue=4, policy="block",
                 max_wait_ms=5.0, autostart=True)
    xs = np.arange(12, dtype=np.float32) * 4     # key 0: three full batches
    done = []

    def feed():
        for lo in range(0, 12, 4):               # 2nd/3rd chunk must wait
            done.append(b.submit(_pts(xs[lo:lo + 4]), _pts(xs[lo:lo + 4])))

    th = threading.Thread(target=feed)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    out = np.concatenate([tk.result(timeout=10) for tk in done])
    b.close()
    np.testing.assert_array_equal(out, _expect(xs))
    assert srv.stats.admission_waits >= 1
    assert srv.stats.queue_depth_peak <= 4


# ---------------------------------------------------------------- pipeline

def test_double_buffer_keeps_two_groups_in_flight():
    srv, b = _mk(batch_size=8, depth=2)
    xs = np.full(24, 4.0) + np.arange(24) * 4    # key 0: three full groups
    tk = b.submit(_pts(xs), _pts(xs))
    b.start()
    out = tk.result(timeout=10)
    b.close()
    np.testing.assert_array_equal(out, _expect(xs))
    assert srv.stats.pipeline_peak == 2
    assert srv.stats.full_flushes == 3


# -------------------------------------------------------------- swap safety

def test_superseded_group_requeues_without_slot_accounting():
    """A group admitted under generation 0 but dispatched after a swap is
    re-routed under the live generation: answered by the new engine, one
    requeue counted, and the per-bucket slot accounting never sees the
    aborted dispatch (occupancy stays <= 1)."""
    old, new = _KeyedEngine(1.0), _KeyedEngine(2.0)
    sw = _SwapDouble(old)
    srv = PathServer(sw, batch_size=8)
    b = CoalescingBatcher(srv, autostart=False)
    xs = np.full(8, 4.0) + np.arange(8) * 4
    tk = b.submit(_pts(xs), _pts(xs))            # queued under gen 0
    sw.swap(new)                                 # published before dispatch
    b.start()
    out = tk.result(timeout=10)
    b.close()
    np.testing.assert_array_equal(out, _expect(xs, 2.0))   # new engine wins
    assert old.dispatched == []                  # stale gen never dispatched
    assert srv.stats.requeued_batches == 1
    assert srv.stats.generation == 1 and srv.stats.swaps == 1
    bstats = srv.stats.per_bucket[0]
    assert bstats.batches == 1 and bstats.slots == 8
    assert bstats.occupancy <= 1.0


def test_inflight_batch_finishes_on_pinned_generation():
    """A swap published while a batch computes: the batch finishes on the
    engine it pinned (old answers) and is counted stale, the next group
    serves on the new generation."""
    old, new = _KeyedEngine(1.0), _KeyedEngine(2.0)
    sw = _SwapDouble(old)
    srv = PathServer(sw, batch_size=8)
    swap_once = []

    orig = old.batch

    def swapping_batch(s, t, bucket=0):
        out = orig(s, t, bucket)
        if not swap_once:
            swap_once.append(True)
            sw.swap(new)                 # mid-dispatch publish
        return out

    old.batch = swapping_batch
    b = CoalescingBatcher(srv, autostart=False)
    xs = np.full(8, 4.0) + np.arange(8) * 4
    tk1 = b.submit(_pts(xs), _pts(xs))
    b.start()
    out1 = tk1.result(timeout=10)
    tk2 = b.submit(_pts(xs), _pts(xs))
    out2 = tk2.result(timeout=10)
    b.close()
    np.testing.assert_array_equal(out1, _expect(xs, 1.0))  # pinned gen 0
    np.testing.assert_array_equal(out2, _expect(xs, 2.0))  # live gen 1
    assert srv.stats.stale_batches == 1
    assert srv.stats.swaps == 1 and srv.stats.generation == 1
    for bstats in srv.stats.per_bucket.values():
        assert bstats.occupancy <= 1.0


# -------------------------------------------------------- real-engine path

@pytest.fixture(scope="module")
def rooms_s():
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 40, seed=11)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.fixture(scope="module")
def real_server(rooms_s):
    srv = PathServer(TorchEngine(pack_bucketed(rooms_s[0], device="cpu")),
                     batch_size=8)
    srv.warmup(paths=True)
    return srv


def test_async_matches_sync_bitwise(real_server, rooms_s):
    srv = real_server
    _, s, t = rooms_s
    ref = srv.query(s, t)
    tickets = [srv.submit(s[i], t[i]) for i in range(len(s))]
    srv.flush()
    assert srv.drain(timeout=60)
    got = np.concatenate([tk.result(timeout=1) for tk in tickets])
    srv.stop_async()
    np.testing.assert_array_equal(ref, got)      # bitwise, padding-invariant
    for bstats in srv.stats.per_bucket.values():
        assert bstats.occupancy <= 1.0


def test_async_argmin_matches_sync_bitwise(real_server, rooms_s):
    srv = real_server
    _, s, t = rooms_s
    ref = srv._dispatch(s[:12], t[:12], want_argmin=True)
    tk = srv.submit(s[:12], t[:12], want_argmin=True)
    srv.flush()
    got = tk.result(timeout=60)
    srv.stop_async()
    assert len(got) == 5
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)


def test_serving_example_runs_on_cpu(capsys):
    """``examples/pathfind_serve_torch.py`` on the CPU twins at a small
    size: slab layout, bf16 slabs, the async gate and path unwinding all
    pass their self-checks."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "pathfind_serve_torch.py"
    spec = importlib.util.spec_from_file_location("pathfind_serve_torch",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rc = example.main(["--device", "cpu", "--map", "rooms-S", "--queries",
                       "48", "--batch", "16", "--paths", "6", "--layout",
                       "slab", "--quantize", "bf16", "--serve-async"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "quantized smoke OK" in out and "identical=yes" in out
