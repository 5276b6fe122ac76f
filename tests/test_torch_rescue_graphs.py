"""CUDA-graph replay of the exact-argmin rescue.

On a CUDA artifact at fixed batch shapes without an edge grid, a quantized
``DeviceEngine`` replays the rescue's exact gather and join as one captured
graph per (bucket, rows) (``serving.query_engine``).  The CPU tests check
what runs here: a CPU artifact rescues eagerly and replays nothing, its
rescue equals ``core.packed.rescue_exact`` spliced, its rescued winners
equal the f32 engine's bit for bit through the synchronous and the
split-phase calls, its warmup leaves the counters and shape keys it always
left, and the engine's locks still pass the port's invariant pass.  The
``cuda``-marked tests check the replayed rescue on the card against the
same engine class run eagerly (``_graphed`` overridden to False in a test
subclass), bit for bit, over every bucket of rooms-S and of rooms-L at
EHL*-20.  This module imports no JAX.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import compress_to_fraction  # noqa: E402
from repro_torch.core.grid import build_ehl  # noqa: E402
from repro_torch.core.maps import make_map  # noqa: E402
from repro_torch.core import packed  # noqa: E402
from repro_torch.core.packed import pack_bucketed, slab_layout  # noqa: E402
from repro_torch.core.visgraph import build_visgraph  # noqa: E402
from repro_torch.core.workload import uniform_queries  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.serving import query_engine  # noqa: E402
from repro_torch.serving.query_engine import (CudaEngine,  # noqa: E402
                                              TorchEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANSWERS = ("d", "covis", "via_s", "hub", "via_t")
ENGINES = {"torch": TorchEngine, "cuda": CudaEngine}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(name: str, seed: int, budget: float, n: int):
    scene = make_map(name, seed=seed)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, budget)
    qs = uniform_queries(scene, graph, n, seed=5)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.fixture(scope="module")
def rooms_s():
    return _scene("rooms-S", 1, 0.2, 300)


def _counts(name: str) -> tuple:
    """(rescued batches, replayed rescues) of engine ``name`` so far."""
    return (REGISTRY.total("rescue_batches_total", engine=name),
            REGISTRY.total("rescue_graph_replays_total", engine=name))


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


def _flags(eng, sb, tb, key) -> np.ndarray:
    """The ambiguity flags of one argmin batch of a quantized engine."""
    return eng._run(sb, tb, key, True)[5].cpu().numpy()


def _rescue_graphs(eng) -> list:
    """The keys of an engine's rescue graphs."""
    return [k for k in eng._graphs if k[2] == "rescue"]


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_cpu_artifact_rescues_eagerly(rooms_s, engine):
    """A CPU artifact's rescue runs op by op: served ``query_paths`` and
    the batcher rescue batches, and none replays a graph; the engine
    captures no rescue graph and allocates no exact-row buffer."""
    from repro_torch.serving import PathServer

    idx, s, t = rooms_s
    eng = ENGINES[engine](pack_bucketed(idx, layout=slab_layout("bf16"),
                                        device="cpu"))
    assert eng.quantized and not eng._graphed()
    srv = PathServer(eng, batch_size=32)
    srv.warmup(paths=True)
    rescued0, replays0 = _counts(eng.name)
    srv.query_paths(s[:120], t[:120], host_index=idx)
    tk = srv.submit(s[:120], t[:120], want_argmin=True)
    srv.flush()
    tk.result(timeout=120)
    srv.stop_async()
    rescued, replays = _counts(eng.name)
    assert rescued > rescued0
    assert replays == replays0
    assert eng._graphs == {} and eng._exact_rows == {}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_cpu_rescue_equals_rescue_exact_spliced(rooms_s, engine):
    """In every bucket, ``_rescue`` with every row forced equals the
    reference composition ``splice_rescue(quant, rescue_exact(...))`` bit
    for bit."""
    idx, s, t = rooms_s
    eng = ENGINES[engine](pack_bucketed(idx, layout=slab_layout("bf16"),
                                        device="cpu"))
    for key, sb, tb in _batches(eng, s, t, 48):
        res = eng._run(sb, tb, key, True)
        every = np.ones(len(sb), bool)
        want = packed.splice_rescue((*res[:5], every), packed.rescue_exact(
            eng.index, sb, tb, eng.bucket_width(key), res[1],
            use_kernels=eng.use_kernels))
        got = eng._rescue(res, every, sb, tb, key)
        assert len(got) == 5
        for name, w, g in zip(ANSWERS, want, got):
            assert w.dtype == g.dtype, name
            np.testing.assert_array_equal(w, g, err_msg=name)


#: what ``PathServer(eng, batch_size=16).warmup(paths=True)`` leaves on a
#: CPU rooms-S artifact, as the engine left it before its device calls
#: shared one executor: the engine's counters that moved, and the
#: ``TRACES`` keys it saw (each as the ``str`` of its fields)
WARMUP_COUNTERS = ("graph_replays_total", "graph_eager_calls_total",
                   "rescue_graph_replays_total", "argmin_rows_total",
                   "rescue_rows_total", "rescue_batches_total")
F32 = "SlabLayout(dist='f32', ids='i32')"
BF16 = "SlabLayout(dist='bf16', ids='u16')"
WARMUP = {
    "f32": ({"graph_eager_calls_total": 4}, [
        ('fold_endpoint', 'cpu', '16', F32, 'bucket', '128', 'torch.float32'),
        ('fold_endpoint', 'cpu', '16', F32, 'bucket', '256', 'torch.float32'),
        ('join_endpoints', 'cpu', '16', '128', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '128', 'True', 'False'),
        ('join_endpoints', 'cpu', '16', '256', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '256', 'True', 'False'),
    ]),
    "bf16": ({"graph_eager_calls_total": 4, "argmin_rows_total": 32}, [
        ('fold_endpoint', 'cpu', '16',
         BF16, 'bucket', '128', 'torch.bfloat16'),
        ('fold_endpoint', 'cpu', '16',
         BF16, 'bucket', '256', 'torch.bfloat16'),
        ('gather_masked_exact', 'cpu', '16', '128', BF16, 'False'),
        ('gather_masked_exact', 'cpu', '16', '256', BF16, 'False'),
        ('join_endpoints', 'cpu', '16', '128', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '128', 'True', 'True'),
        ('join_endpoints', 'cpu', '16', '256', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '256', 'True', 'True'),
        ('join_masked', 'cpu', '16', '128', 'True', 'False'),
        ('join_masked', 'cpu', '16', '256', 'True', 'False'),
    ]),
    "f32-slab": ({"graph_eager_calls_total": 2}, [
        ('fold_endpoint', 'cpu', '16', F32, 'slab', '256', 'torch.float32'),
        ('join_endpoints', 'cpu', '16', '256', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '256', 'True', 'False'),
    ]),
    "bf16-slab": ({"graph_eager_calls_total": 2, "argmin_rows_total": 16}, [
        ('fold_endpoint', 'cpu', '16', BF16, 'slab', '256', 'torch.bfloat16'),
        ('gather_masked_exact', 'cpu', '16', '256', BF16, 'True'),
        ('join_endpoints', 'cpu', '16', '256', 'False', 'False'),
        ('join_endpoints', 'cpu', '16', '256', 'True', 'True'),
        ('join_masked', 'cpu', '16', '256', 'True', 'False'),
    ]),
}


@pytest.mark.parametrize("kind", sorted(WARMUP))
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_cpu_warmup_counters_and_keys(monkeypatch, rooms_s, engine, kind):
    """``PathServer.warmup(paths=True)`` on a CPU artifact moves the
    engine's counters and sees the shape keys it always did: the same
    eager calls, argmin slots and rescue runs, and nothing replayed."""
    from repro_torch.serving import PathServer

    idx, _, _ = rooms_s
    layout, _, packer = kind.partition("-")
    pack = packed.pack_index if packer else pack_bucketed
    eng = ENGINES[engine](pack(idx, layout=slab_layout(layout),
                               device="cpu"))
    monkeypatch.setattr(packed.TRACES, "_seen", set())
    monkeypatch.setattr(packed.TRACES, "count", 0)
    before = [REGISTRY.total(c, engine=eng.name) for c in WARMUP_COUNTERS]
    PathServer(eng, batch_size=16).warmup(paths=True)
    moved = {c: b - a for c, a, b in zip(
        WARMUP_COUNTERS, before,
        [REGISTRY.total(c, engine=eng.name) for c in WARMUP_COUNTERS])}
    counters, keys = WARMUP[kind]
    assert {c: v for c, v in moved.items() if v} == counters
    assert {tuple(map(str, k)) for k in packed.TRACES._seen} == set(keys)
    assert packed.TRACES.count == len(keys)


@pytest.mark.parametrize("path", ["sync", "staged"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_cpu_rescued_winners_equal_f32_engine(rooms_s, engine, path):
    """In every bucket, the quantized engine's argmin answers after the
    rescue equal the f32 engine's bit for bit on covis and the winners,
    and on the distance of every flagged row; through ``batch_argmin`` and
    through ``stage``/``dispatch_staged``.  Some batch is rescued."""
    idx, s, t = rooms_s
    cls = ENGINES[engine]
    eng = cls(pack_bucketed(idx, layout=slab_layout("bf16"), device="cpu"))
    f32 = cls(pack_bucketed(idx, device="cpu"))
    rescued0, _ = _counts(eng.name)
    flagged = 0
    for key, sb, tb in _batches(eng, s, t, 48):
        amb = _flags(eng, sb, tb, key)
        flagged += int(amb.sum())
        if path == "sync":
            got = eng.batch_argmin(sb, tb, key)
        else:
            got = eng.dispatch_staged(eng.stage(sb, tb, key), key,
                                      want_argmin=True).wait()
        want = f32.batch_argmin(sb, tb, key)
        assert len(got) == 5
        for name, w, g in zip(ANSWERS[1:], want[1:], got[1:]):
            np.testing.assert_array_equal(w, g, err_msg=name)
        np.testing.assert_array_equal(want[0][amb], got[0][amb])
    assert flagged > 0
    assert _counts(eng.name)[0] > rescued0


def test_rescue_lock_order_passes_analysis():
    """The rescue takes the engine's graph lock (rank ``engine.swap``) and
    only the obs leaves inside it: the port's lock-order and hot-path-sync
    rules find nothing, and the rescue's copies sit at marked lines."""
    from repro_torch import analysis
    from repro_torch.analysis.callgraph import CallGraph
    from repro_torch.analysis.checkers import lock_order

    project = analysis.load_project(
        [os.path.join(REPO, "src", "repro_torch")], root=REPO)
    assert analysis.run(project,
                        select=["lock-order", "hot-path-sync"]) == []
    index = lock_order._LockIndex(project, CallGraph(project, precise=True),
                                  lock_order._ranks(project))
    assert index.attr[("DeviceEngine", "_graph_lock")] == "engine.swap"


# ----------------------------------------------------------------- the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m cuda` on the "
                    "card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def rooms_l():
    """rooms-L seed 0 at EHL*-20, the benchmark's map and budget."""
    return _scene("rooms-L", 0, 0.2, 2000)


def _engines(idx, card, cls=CudaEngine):
    """A graph-replaying engine and an eager one of class ``cls`` on one
    bf16/u16 artifact."""
    class Eager(cls):
        def _graphed(self):
            return False

    art = pack_bucketed(idx, layout=slab_layout("bf16"), device=card)
    return cls(art), Eager(art)


def _spy(monkeypatch) -> list:
    """Record the exact five outputs each rescue hands to the splice."""
    seen = []
    real = query_engine.splice_rescue

    def spy(quant6, exact5):
        seen.append(tuple(e.cpu().numpy() for e in exact5))
        return real(quant6, exact5)

    monkeypatch.setattr(query_engine, "splice_rescue", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["rooms_s", "rooms_l"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_replayed_rescue_equals_eager_bit_for_bit(card, request, monkeypatch,
                                                  scene, engine):
    """In every bucket, the replayed rescue's five exact outputs and the
    spliced answers equal the eager rescue's bit for bit: every row forced
    through the rescue, then ``batch_argmin`` with the run's own flags and
    the split-phase pair."""
    idx, s, t = request.getfixturevalue(scene)
    eng, eager = _engines(idx, card, ENGINES[engine])
    assert eng._graphed() and not eager._graphed()
    rows = 256
    eng.warmup(rows, want_argmin=True)
    assert len(_rescue_graphs(eng)) == eng.num_buckets
    seen = _spy(monkeypatch)
    _, replays0 = _counts(eng.name)
    flagged = 0
    for key, sb, tb in _batches(eng, s, t, rows):
        res, res_e = eng._run(sb, tb, key, True), eager._run(sb, tb, key,
                                                             True)
        every = np.ones(rows, bool)
        got = eng._rescue(res, every, sb, tb, key)
        exact = seen[-1]
        want = eager._rescue(res_e, every, sb, tb, key)
        for name, w, g, we, ge in zip(ANSWERS, want, got, seen[-1], exact):
            np.testing.assert_array_equal(we, ge, err_msg=name)
            np.testing.assert_array_equal(w, g, err_msg=name)
        flagged += int(_flags(eng, sb, tb, key).sum())
        for name, w, g in zip(ANSWERS, eager.batch_argmin(sb, tb, key),
                              eng.batch_argmin(sb, tb, key)):
            np.testing.assert_array_equal(w, g, err_msg=name)
        got = eng.dispatch_staged(eng.stage(sb, tb, key), key, True).wait()
        for name, w, g in zip(ANSWERS, eager.batch_argmin(sb, tb, key), got):
            np.testing.assert_array_equal(w, g, err_msg=name)
    assert flagged > 0
    assert _counts(eng.name)[1] - replays0 >= eng.num_buckets


@pytest.mark.cuda
def test_two_threads_get_their_own_rescued_answers(card, rooms_s):
    """Two threads interleaving rescued ``batch_argmin`` calls on one
    engine, on different queries at one shape, each get the answers of
    their own queries."""
    idx, s, t = rooms_s
    eng, eager = _engines(idx, card)
    rows = 64
    eng.warmup(rows, want_argmin=True)
    key, sb, tb = max(_batches(eng, s, t, rows),
                      key=lambda b: _flags(eager, b[1], b[2], b[0]).sum())
    jobs = [(sb, tb), (tb[::-1].copy(), sb[::-1].copy())]
    rescued = sum(bool(_flags(eager, x, y, key).any()) for x, y in jobs)
    assert rescued > 0
    wants = [eager.batch_argmin(x, y, key) for x, y in jobs]
    _, replays0 = _counts(eng.name)
    errors = []
    start = threading.Barrier(2)

    def serve(i):
        x, y = jobs[i]
        start.wait()
        for _ in range(50):
            got = eng.batch_argmin(x, y, key)
            if not all(np.array_equal(a, b) for a, b in zip(got, wants[i])):
                errors.append(i)

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors
    assert _counts(eng.name)[1] - replays0 == 50 * rescued
    assert not np.array_equal(wants[0][0], wants[1][0])


@pytest.mark.cuda
def test_warmup_captures_every_rescue_graph(card, rooms_s):
    """After ``warmup(paths=True)`` serving meets no cold key: sync
    requests, ``query_paths`` and the batcher's argmin rescue through the
    captured graphs, and no new graph is captured."""
    from repro_torch.core.packed import TRACES
    from repro_torch.serving import PathServer

    idx, s, t = rooms_s
    eng, _ = _engines(idx, card)
    srv = PathServer(eng, batch_size=48)
    srv.warmup(paths=True)
    assert sorted(_rescue_graphs(eng)) == [(b, 48, "rescue")
                                           for b in range(eng.num_buckets)]
    cold = TRACES.count
    _, replays0 = _counts(eng.name)
    srv.query(s, t)
    srv.query_paths(s, t, host_index=idx)
    tk = srv.submit(s, t, want_argmin=True)
    srv.flush()
    tk.result(timeout=120)
    srv.stop_async()
    assert TRACES.count == cold
    assert _counts(eng.name)[1] > replays0
    assert len(_rescue_graphs(eng)) == eng.num_buckets


@pytest.mark.cuda
def test_every_rescue_is_a_replay(card, rooms_s):
    """Over served traffic, ``rescue_graph_replays_total`` advances with
    ``rescue_batches_total``, one for one, and ``graph_replays_total``
    counts only the argmin graphs."""
    from repro_torch.serving import PathServer

    idx, s, t = rooms_s
    eng, _ = _engines(idx, card)
    srv = PathServer(eng, batch_size=64)
    srv.warmup(paths=True)
    rescued0, replays0 = _counts(eng.name)
    graphs0 = REGISTRY.total("graph_replays_total", engine=eng.name)
    batches0 = srv.stats.batches
    srv.query_paths(s, t, host_index=idx)
    rescued, replays = _counts(eng.name)
    assert rescued - rescued0 > 0
    assert replays - replays0 == rescued - rescued0
    assert REGISTRY.total("graph_replays_total", engine=eng.name) - graphs0 \
        == srv.stats.batches - batches0
