"""CUDA-graph replay of the serving engine's fold and join.

On a CUDA artifact at fixed batch shapes without an edge grid, a
``DeviceEngine`` captures each batch shape's fold and join once and
replays it (``serving.query_engine``).  The CPU tests check what runs
here: a CPU artifact serves eagerly and counts its device calls in
``graph_eager_calls_total``, the launch accounting that replays use
(``kernels.launches``), and the rank of the engine's graph lock.  The
``cuda``-marked tests check the replays on the card against the eager path
of the same engine class (``_graphed`` overridden to False in a test
subclass, so the same ``_call`` takes its eager branch), bit for bit.  This
module imports no JAX.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.compression import compress_to_fraction  # noqa: E402
from repro_torch.core.grid import build_ehl  # noqa: E402
from repro_torch.core.maps import make_map  # noqa: E402
from repro_torch.core.packed import pack_bucketed, slab_layout  # noqa: E402
from repro_torch.core.visgraph import build_visgraph  # noqa: E402
from repro_torch.core.workload import uniform_queries  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANSWERS = ("d", "covis", "via_s", "hub", "via_t", "amb")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name: str):
    scene = make_map(name, seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 300, seed=5)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.fixture(scope="module")
def rooms_s():
    return _scene("rooms-S")


def _counts(name: str) -> tuple:
    return (REGISTRY.total("graph_replays_total", engine=name),
            REGISTRY.total("graph_eager_calls_total", engine=name))


def _fold_join_graphs(eng) -> list:
    """The keys of an engine's fold and join graphs (its rescue graphs,
    keyed ``"rescue"``, left out)."""
    return [k for k in eng._graphs if k[2] != "rescue"]


def _batches(eng, s, t, rows: int):
    """(bucket, s, t) for every bucket: the first ``rows`` queries that may
    be dispatched there (routing key at most the bucket), zero-padded to
    ``rows``; where none may, pairs of cell centres of regions in buckets
    up to it."""
    keys = eng.buckets_of(s, t)
    for k in range(eng.num_buckets):
        sel = np.nonzero(keys <= k)[0][:rows]
        sb = np.zeros((rows, 2), np.float32)
        tb = np.zeros((rows, 2), np.float32)
        sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
        if not len(sel):
            cells = np.nonzero(eng._np_bucket[eng._np_mapper] <= k)[0]
            ix, iy = cells % eng.index.nx, cells // eng.index.nx
            pts = ((np.stack([ix, iy], 1) + 0.5)
                   * eng.index.cell_size).astype(np.float32)[:2 * rows]
            n = len(pts) // 2
            sb[:n], tb[:n] = pts[:n], pts[n:2 * n]
        yield k, sb, tb


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_cpu_artifact_serves_eagerly(rooms_s, layout):
    """A CPU artifact captures no graph: every device call of the sync
    path, ``query_paths`` and the split-phase pair counts one eager call
    and no replay."""
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    eng = CudaEngine(pack_bucketed(idx, layout=slab_layout(layout),
                                   device="cpu"))
    assert not eng._graphed()
    srv = PathServer(eng, batch_size=32)
    srv.warmup(paths=True)
    replays0, eager0 = _counts(eng.name)
    batches0 = srv.stats.batches
    srv.query(s[:70], t[:70])
    srv.query_paths(s[:40], t[:40], host_index=idx)
    calls = srv.stats.batches - batches0
    key, sb, tb = next(_batches(eng, s, t, 32))
    want = eng.batch_argmin(sb, tb, key)
    got = eng.dispatch_staged(eng.stage(sb, tb, key), key,
                              want_argmin=True).wait()
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    replays, eager = _counts(eng.name)
    assert calls >= 4
    assert replays == replays0
    assert eager - eager0 == calls + 2
    assert eng._graphs == {}


def test_sharded_engine_counts_eager_calls(rooms_s):
    """The sharded engine's device calls go through its router, never a
    graph: each dispatched group counts one eager call."""
    from repro_torch.serving import PathServer
    from repro_torch.sharding import ShardedQueryEngine

    idx, s, t = rooms_s
    eng = ShardedQueryEngine(idx, num_shards=2, backend="torch",
                             device="cpu")
    srv = PathServer(eng, batch_size=32)
    replays0, eager0 = _counts(eng.name)
    batches0 = srv.stats.batches
    srv.query(s[:50], t[:50])
    replays, eager = _counts(eng.name)
    assert replays == replays0
    assert eager - eager0 == srv.stats.batches - batches0 > 0


def _fake_kernel():
    def kernel():
        pass
    kernel.launches = 0
    return kernel


def test_launches_recorded_in_capture_count_on_replay():
    """A launch counts at once; inside ``recording`` it is recorded, not
    counted, and each ``replay`` counts the recorded launches again, with
    their analytic cost to the installed profile capture."""
    k = _fake_kernel()
    reg = obs.MetricsRegistry()
    with obs.profiled(registry=reg):
        launches.count(k, "segvis", (256, 128))
        assert k.launches == 1
        with launches.recording() as rec:
            launches.count(k, "segvis", (256, 128))
            launches.count(k, "label_join_rowmin", (8, 128), 2)
        assert k.launches == 1
        assert [r[1:] for r in rec] == [("segvis", (256, 128), 4),
                                        ("label_join_rowmin", (8, 128), 2)]
        launches.replay(rec)
        launches.replay(rec)
    assert k.launches == 5
    ops_ = {dict(m.labels)["kernel"]: m.value
            for m in reg.series("kernel_cost_ops_total")}
    one = obs.profile.kernel_cost("segvis", (256, 128))["ops"]
    join = obs.profile.kernel_cost("label_join_rowmin", (8, 128), 2)["ops"]
    assert ops_ == {"segvis": 3 * one, "label_join_rowmin": 2 * join}


def test_launch_recording_is_per_thread():
    """A thread that records a capture does not swallow another thread's
    launches, and the recording ends with its block."""
    k = _fake_kernel()
    inside, outside = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        launches.count(k, "segvis", (1, 1))
        outside.set()

    th = threading.Thread(target=other)
    th.start()
    with launches.recording() as rec:
        inside.set()
        assert outside.wait(10)
    th.join()
    assert rec == [] and k.launches == 1
    launches.count(k, "segvis", (1, 1))
    assert k.launches == 2


def test_graph_lock_rank_passes_lock_order():
    """The engine's graph lock is made under a ranked name of the
    reference's table (``engine.swap``), which the lock-order rule resolves
    on ``DeviceEngine``; the port has no finding of the rule, and the rank
    lies above the locks released before engine calls and below every
    lock taken inside them."""
    from repro_torch import analysis
    from repro_torch.analysis.callgraph import CallGraph
    from repro_torch.analysis.checkers import lock_order
    from repro_torch.obs.locks import LOCK_RANKS

    project = analysis.load_project(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO)
    assert analysis.run(project, select=["lock-order"]) == []
    index = lock_order._LockIndex(project, CallGraph(project, precise=True),
                                  lock_order._ranks(project))
    name = index.attr[("DeviceEngine", "_graph_lock")]
    assert name == "engine.swap"
    rank = LOCK_RANKS[name]
    assert all(LOCK_RANKS[n] < rank for n in
               ("indexing.adapt", "batcher.queue"))
    assert all(LOCK_RANKS[n] > rank for n in
               ("obs.profile", "obs.registry", "obs.series", "obs.spans"))


def test_graph_lock_order_at_run_time(monkeypatch, rooms_s):
    """Under ``REPRO_LOCK_CHECK=1`` the engine's graph lock is an
    ``OrderedLock``: taking the registry's and a series' locks under it
    passes, taking it under a series' lock raises."""
    from repro_torch.obs.locks import LockOrderError, OrderedLock, make_lock
    from repro_torch.serving import CudaEngine

    monkeypatch.setenv("REPRO_LOCK_CHECK", "1")
    idx, _, _ = rooms_s
    graphs = CudaEngine(pack_bucketed(idx, device="cpu"))._graph_lock
    assert isinstance(graphs, OrderedLock)
    registry, series = make_lock("obs.registry"), make_lock("obs.series")
    with graphs, registry, series:
        pass
    with series:
        with pytest.raises(LockOrderError):
            graphs.acquire()


# ----------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def rooms_m():
    return _scene("rooms-M")


def _engines(idx, layout: str, card):
    """A graph-replaying CudaEngine and an eager one on one artifact."""
    from repro_torch.serving import CudaEngine

    class EagerCudaEngine(CudaEngine):
        def _graphed(self):
            return False

    art = pack_bucketed(idx, layout=slab_layout(layout), device=card)
    return CudaEngine(art), EagerCudaEngine(art)


def _host(res) -> tuple:
    res = res if isinstance(res, tuple) else (res,)
    return tuple(r.cpu().numpy() for r in res)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["rooms_s", "rooms_m"])
@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_replay_equals_eager_bit_for_bit(card, request, scene, layout):
    """In every bucket, the replayed fold and join equal the eager one's
    bit for bit: the device outputs (with ``amb`` on bf16), ``batch``,
    ``batch_argmin`` after the spliced rescue, and the split-phase path
    with two batches in flight."""
    idx, s, t = request.getfixturevalue(scene)
    eng, eager = _engines(idx, layout, card)
    assert eng._graphed() and not eager._graphed()
    rows = 64
    eng.warmup(rows, want_argmin=True)
    batches = list(_batches(eng, s, t, rows))
    replays0, _ = _counts(eng.name)
    for key, sb, tb in batches:
        for argmin in (False, True):
            got = _host(eng._run(sb, tb, key, argmin))
            want = _host(eager._run(sb, tb, key, argmin))
            assert len(got) == (6 if argmin and layout == "bf16"
                                else 5 if argmin else 1)
            for name, w, g in zip(ANSWERS, want, got):
                np.testing.assert_array_equal(w, g, err_msg=name)
        np.testing.assert_array_equal(eager.batch(sb, tb, key),
                                      eng.batch(sb, tb, key))
        want = eager.batch_argmin(sb, tb, key)
        for name, w, g in zip(ANSWERS, want, eng.batch_argmin(sb, tb, key)):
            np.testing.assert_array_equal(w, g, err_msg=name)
        for argmin in (False, True):
            want = eager.batch_argmin(sb, tb, key) if argmin \
                else (eager.batch(sb, tb, key),)
            pend = [eng.dispatch_staged(eng.stage(x, y, key), key, argmin)
                    for x, y in ((sb, tb), (tb, sb))]
            swapped = eager.batch_argmin(tb, sb, key) if argmin \
                else (eager.batch(tb, sb, key),)
            for w_, p in zip((want, swapped), pend):
                for name, w, g in zip(ANSWERS, w_, p.wait()):
                    np.testing.assert_array_equal(w, g, err_msg=name)
    replays, _ = _counts(eng.name)
    assert replays - replays0 >= 8 * len(batches)


@pytest.mark.cuda
def test_two_threads_get_their_own_answers(card, rooms_s):
    """Two threads interleaving sync calls on one engine, on different
    queries at one shape, each get the answers of their own queries."""
    idx, s, t = rooms_s
    eng, eager = _engines(idx, "f32", card)
    eng.warmup(64, want_argmin=True)
    key, sb, tb = next(_batches(eng, s, t, 64))
    jobs = [(sb, tb), (tb[::-1].copy(), sb[::-1].copy())]
    wants = [(eager.batch(x, y, key), eager.batch_argmin(x, y, key))
             for x, y in jobs]
    errors = []
    start = threading.Barrier(2)

    def serve(i):
        x, y = jobs[i]
        start.wait()
        for _ in range(50):
            d = eng.batch(x, y, key)
            am = eng.batch_argmin(x, y, key)
            if not (np.array_equal(d, wants[i][0]) and all(
                    np.array_equal(a, b) for a, b in zip(am, wants[i][1]))):
                errors.append(i)

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors
    assert not np.array_equal(wants[0][0], wants[1][0])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_warmup_captures_and_serving_stays_warm(card, rooms_s, layout):
    """``warmup`` captures every served shape: over a served stream (sync
    requests, ``query_paths`` with the rescue on bf16, the batcher)
    ``TRACES.count`` stays unchanged, every device call replays a graph
    and none runs eagerly."""
    from repro_torch.core.packed import TRACES
    from repro_torch.serving import PathServer

    idx, s, t = rooms_s
    eng, _ = _engines(idx, layout, card)
    srv = PathServer(eng, batch_size=48)
    srv.warmup(paths=True)
    assert len(_fold_join_graphs(eng)) == 2 * eng.num_buckets
    cold = TRACES.count
    replays0, eager0 = _counts(eng.name)
    batches0 = srv.stats.batches
    srv.query(s, t)
    srv.query_paths(s[:40], t[:40], host_index=idx)
    calls = srv.stats.batches - batches0
    for argmin in (False, True):
        tk = srv.submit(s, t, want_argmin=argmin)
        srv.flush()
        tk.result(timeout=120)
    srv.stop_async()
    replays, eager = _counts(eng.name)
    assert TRACES.count == cold
    assert eager == eager0
    assert replays - replays0 >= calls + 2
    assert len(_fold_join_graphs(eng)) == 2 * eng.num_buckets


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_launch_counters_advance_per_replay_as_eagerly(card, rooms_s,
                                                       layout):
    """A replayed batch advances ``segvis.launches``,
    ``label_join_rowmin.launches`` and ``kernel_cost_*_total`` by what the
    eager batch advances them."""
    from repro_torch.kernels.label_join import label_join_rowmin
    from repro_torch.kernels.segvis import segvis

    idx, s, t = rooms_s
    eng, eager = _engines(idx, layout, card)
    eng.warmup(64, want_argmin=True)
    key, sb, tb = next(_batches(eng, s, t, 64))

    def deltas(e, argmin):
        reg = obs.MetricsRegistry()
        before = (segvis.launches, label_join_rowmin.launches)
        with obs.profiled(registry=reg):
            e._run(sb, tb, key, argmin)
        return (segvis.launches - before[0],
                label_join_rowmin.launches - before[1],
                {(m.name, dict(m.labels)["kernel"]): m.value
                 for m in reg.metrics()
                 if m.name.startswith("kernel_cost_")})

    for argmin in (False, True):
        replays0, _ = _counts(eng.name)
        got = deltas(eng, argmin)
        assert _counts(eng.name)[0] == replays0 + 1
        want = deltas(eager, argmin)
        assert got == want
        assert got[0] == 3 and got[1] == 1


@pytest.mark.cuda
def test_grid_artifact_stays_eager(card, rooms_s):
    """An artifact with an edge grid serves eagerly (its chunked walk is
    captured as no graph): eager calls count, replays do not, and its
    answers equal the dense artifact's replayed ones."""
    from repro_torch.kernels.segvis_tiles import segvis_tiles
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    grid = CudaEngine(pack_bucketed(idx, edge_grid=True, device=card))
    dense = CudaEngine(pack_bucketed(idx, edge_grid=False, device=card))
    assert not grid._graphed() and dense._graphed()
    a, b = PathServer(grid, batch_size=64), PathServer(dense, batch_size=64)
    a.warmup(paths=True)
    b.warmup(paths=True)
    assert grid._graphs == {}
    replays0, eager0 = _counts(grid.name)
    tiles = segvis_tiles.launches
    batches0 = a.stats.batches
    got = a._dispatch(s, t, True)
    replays, eager = _counts(grid.name)
    assert segvis_tiles.launches > tiles
    assert replays == replays0
    assert eager - eager0 == a.stats.batches - batches0
    for x, y in zip(got, b._dispatch(s, t, True)):
        np.testing.assert_array_equal(x, y)
