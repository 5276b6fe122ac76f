"""The host unwind's chain table against the reference (rooms-S, CPU).

``serving.unwind.unwind_path`` walks every (vertex, hub) chain of a host
index's labels once, on the index's first use, and unwinds each polyline
from that table; its polylines must equal the JAX package's
``repro.core.query.unwind_path`` point for point (float64 [2] arrays, the
same near-duplicates dropped), walked by the reference's own ``HubLabels``
over the same labels: for every label of the index, for endpoints on the
vias, for a zero-length query, for a missing pair and a next-hop cycle, and
through ``PathServer.query_paths`` on a CPU device engine.  The port's
``repro_torch.core.query.unwind_path`` is checked beside it on every label.
Each index object gets its own table, dropped with it.
"""

import dataclasses
import gc
import importlib
import math
import threading
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.compression import compress_to_fraction  # noqa: E402
from repro_torch.core.grid import build_ehl  # noqa: E402
from repro_torch.core.hublabel import HubLabels  # noqa: E402
from repro_torch.core.maps import make_map  # noqa: E402
from repro_torch.core.packed import pack_bucketed  # noqa: E402
from repro_torch.core.visgraph import build_visgraph  # noqa: E402
from repro_torch.core.workload import uniform_queries  # noqa: E402
from repro_torch.serving import CudaEngine, PathServer, TorchEngine  # noqa: E402
from repro_torch.serving import engine as serving_engine  # noqa: E402
from repro_torch.serving import unwind  # noqa: E402

ref_query = importlib.import_module("repro.core.query")
ref_hublabel = importlib.import_module("repro.core.hublabel")
ref_edist = importlib.import_module("repro.core.geometry").edist
port_unwind_path = importlib.import_module("repro_torch.core.query").unwind_path


def oracle(idx, s, t, via_s, hub, via_t):
    """The JAX package's ``unwind_path`` on the same nodes and labels, the
    labels walked by the reference's ``HubLabels``."""
    ref = types.SimpleNamespace(
        graph=types.SimpleNamespace(nodes=idx.graph.nodes),
        hl=ref_hublabel.HubLabels(order=idx.hl.order, labels=idx.hl.labels))
    return ref_query.unwind_path(ref, s, t, via_s, hub, via_t)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rooms_s():
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 160, seed=29)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


def _shifted(idx, dx: float):
    """Another index object with the same labels and every node moved by
    ``dx``: the same winners unwind to other polylines."""
    return dataclasses.replace(idx, graph=dataclasses.replace(
        idx.graph, nodes=idx.graph.nodes + dx))


def _labels(idx):
    """Every (vertex, hub) pair of the index's labels."""
    return [(v, int(h)) for v, (hs, _, _) in enumerate(idx.hl.labels)
            for h in hs]


def assert_same_path(got, want):
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert p.dtype == np.float64 and p.shape == (2,)
        assert q.dtype == np.float64
        np.testing.assert_array_equal(p, q)


def _server(idx, engine_cls=TorchEngine):
    bx = pack_bucketed(idx, device="cpu")
    return PathServer(engine_cls(bx), batch_size=32,
                      telemetry=obs.Telemetry(registry=obs.MetricsRegistry()))


def test_scalar_distance_is_edist():
    """The dedup's scalar sqrt(dx*dx + dy*dy) rounds as the reference's
    edist does."""
    g = np.random.default_rng(5)
    p = g.uniform(-200, 200, (4000, 2))
    q = np.concatenate([g.uniform(-200, 200, (1000, 2)),
                        p[1000:2000] + g.normal(0, 1e-12, (1000, 2)),
                        p[2000:3000] + g.normal(0, 1e-6, (1000, 2)),
                        p[3000:] * (1 + 1e-15)])
    for a, b in zip(p, q):
        (ax, ay), (bx, by) = a.tolist(), b.tolist()
        dx, dy = ax - bx, ay - by
        assert math.sqrt(dx * dx + dy * dy) == ref_edist(a, b)


def test_every_label_chain_matches_the_oracle(rooms_s):
    idx, s, t = rooms_s
    pairs = _labels(idx)
    by_hub = {}
    for v, h in pairs:
        by_hub.setdefault(h, []).append(v)
    g = np.random.default_rng(7)
    for k, (v, h) in enumerate(pairs):
        w = by_hub[h][g.integers(len(by_hub[h]))]
        sp, tp = s[k % len(s)], t[k % len(t)]
        for triple in ((v, h, h), (h, h, v), (v, h, w)):
            got = unwind.unwind_path(idx, sp, tp, *triple)
            assert_same_path(got, oracle(idx, sp, tp, *triple))
            assert_same_path(got, port_unwind_path(idx, sp, tp, *triple))


def test_endpoints_on_the_vias(rooms_s):
    """An endpoint placed exactly on its via drops the via, as the oracle
    does; float32 endpoints near it keep both."""
    idx, _, _ = rooms_s
    nodes = idx.graph.nodes
    for v, h in _labels(idx):
        for via_t in (h, v):
            for s_, t_ in ((nodes[v], nodes[via_t]),
                           (nodes[v].astype(np.float32),
                            nodes[via_t].astype(np.float32))):
                got = unwind.unwind_path(idx, s_, t_, v, h, via_t)
                assert_same_path(got, oracle(idx, s_, t_, v, h, via_t))


def test_via_s_hub_via_t_all_one(rooms_s):
    idx, s, t = rooms_s
    for v in range(idx.graph.num_nodes):
        got = unwind.unwind_path(idx, s[v], t[v], v, v, v)
        assert_same_path(got, oracle(idx, s[v], t[v], v, v, v))
        assert len(got) == 3


def test_s_equals_t(rooms_s):
    idx, s, _ = rooms_s
    for k, (v, h) in enumerate(_labels(idx)[:120]):
        got = unwind.unwind_path(idx, s[k], s[k], v, h, v)
        assert_same_path(got, oracle(idx, s[k], s[k], v, h, v))


def test_a_pair_missing_from_the_labels_raises(rooms_s):
    idx, s, t = rooms_s
    idx = _shifted(idx, 0.0)            # a table of its own
    have = set(_labels(idx))
    v, h = next((v, h) for v in range(idx.graph.num_nodes)
                for h in range(idx.graph.num_nodes)
                if v != h and (v, h) not in have)
    for via_s, via_t in ((v, h), (h, v)):
        with pytest.raises(KeyError):
            oracle(idx, s[0], t[0], via_s, h, via_t)
        with pytest.raises(KeyError):
            unwind.unwind_path(idx, s[0], t[0], via_s, h, via_t)
    assert (v, h) not in unwind.chain_table(idx)[0].chains


def test_a_next_hop_cycle_raises():
    """Labels whose next hops loop raise the reference's RuntimeError
    (the table's while it is built)."""
    z = np.zeros(0, np.int64)
    labels = [(np.array([2]), np.array([1.0]), np.array([1])),
              (np.array([2]), np.array([1.0]), np.array([0])),
              (z, np.zeros(0), z)]
    graph = dataclasses.make_dataclass("G", ["nodes"])(
        np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]]))
    idx = dataclasses.make_dataclass("I", ["graph", "hl"])(
        graph, HubLabels(order=np.arange(3), labels=labels))
    p = np.zeros(2)
    with pytest.raises(RuntimeError, match="cycle"):
        oracle(idx, p, p, 0, 2, 2)
    with pytest.raises(RuntimeError, match="cycle"):
        unwind.unwind_path(idx, p, p, 0, 2, 2)


@pytest.mark.parametrize("engine_cls", [TorchEngine, CudaEngine])
def test_query_paths_matches_the_row_by_row_oracle(rooms_s, engine_cls):
    """``query_paths`` on a CPU device engine returns the distances and
    winners' polylines of the row-by-row reference, and counts the rows it
    unwound and the chains it walked from the labels: every label's, once,
    on the index's first request."""
    idx, s, t = rooms_s
    idx = _shifted(idx, 0.0)            # no table yet: the first request builds it
    srv = _server(idx, engine_cls)
    srv.warmup(paths=True)
    d0, covis, via_s, hub, via_t = srv._dispatch(s, t, want_argmin=True)
    d, paths = srv.query_paths(s, t, host_index=idx)
    np.testing.assert_array_equal(d, d0)
    unwound = ~covis & np.isfinite(d0)
    assert unwound.sum() > 20 and covis.sum() > 0
    for i, p in enumerate(paths):
        if covis[i]:
            want = [s[i].astype(np.float64), t[i].astype(np.float64)]
        elif not np.isfinite(d0[i]):
            want = []
        else:
            want = oracle(idx, s[i], t[i], int(via_s[i]), int(hub[i]),
                          int(via_t[i]))
        assert_same_path(p, want)
    chains = len(_labels(idx))
    assert srv.stats.unwind_rows == unwound.sum()
    assert srv.stats.unwind_chain_fills == chains
    srv.query_paths(s, t, host_index=idx)     # the table is there
    assert srv.stats.unwind_rows == 2 * unwound.sum()
    assert srv.stats.unwind_chain_fills == chains
    reg = srv.telemetry.registry
    assert reg.total("unwind_rows_total", srv=srv.stats.labels["srv"]) == \
        2 * unwound.sum()
    assert reg.total("unwind_chain_fills_total") == chains


def test_two_indexes_through_one_server(rooms_s):
    """Two host index objects with the same labels and other coordinates:
    each request unwinds from its own index's table."""
    idx, s, t = rooms_s
    other = _shifted(idx, 0.25)
    srv = _server(idx)
    _, covis, via_s, hub, via_t = srv._dispatch(s, t, want_argmin=True)
    got = {id(ix): srv.query_paths(s, t, host_index=ix)[1]
           for ix in (idx, other, idx, other)}
    moved = 0
    for ix in (idx, other):
        for i, p in enumerate(got[id(ix)]):
            if p and not covis[i]:
                assert_same_path(p, oracle(ix, s[i], t[i], int(via_s[i]),
                                           int(hub[i]), int(via_t[i])))
                moved += not np.array_equal(p[1], got[id(idx)][i][1])
    assert moved > 0
    assert unwind.chain_table(idx)[0] is not unwind.chain_table(other)[0]


def test_a_dropped_index_takes_its_table_and_leaves_no_stale_chains(rooms_s):
    idx, s, t = rooms_s
    triples = [(v, h, h) for v, h in _labels(idx)[::7]]
    first = _shifted(idx, 0.5)
    for k, tr in enumerate(triples):
        unwind.unwind_path(first, s[k], t[k], *tr)
    key = id(first)
    assert key in unwind._TABLES
    del first
    gc.collect()
    assert key not in unwind._TABLES
    # fresh indexes, one of which may well reuse the freed id
    fresh = [_shifted(idx, -0.5 - j) for j in range(8)]
    for ix in fresh:
        for k, tr in enumerate(triples):
            assert_same_path(unwind.unwind_path(ix, s[k], t[k], *tr),
                             oracle(ix, s[k], t[k], *tr))
    # an entry whose weak reference names another object is never read
    a, b = _shifted(idx, 1.0), _shifted(idx, 2.0)
    table_a = unwind.chain_table(a)[0]
    unwind._TABLES[id(b)] = (weakref.ref(a), table_a)
    assert unwind.chain_table(b)[0] is not table_a
    tr = triples[0]
    assert_same_path(unwind.unwind_path(b, s[0], t[0], *tr),
                     oracle(b, s[0], t[0], *tr))


def test_threads_share_one_table(rooms_s):
    """Threads that unwind through one index with no table yet, so that
    each may build one, all get the reference's polylines."""
    idx, s, t = rooms_s
    ix = _shifted(idx, 0.0)
    triples = [(v, h, h) for v, h in _labels(ix)]
    errors = []

    def work(off):
        try:
            for j in range(len(triples)):
                k = (j + off) % len(triples)
                assert_same_path(
                    unwind.unwind_path(ix, s[k % len(s)], t[k % len(t)],
                                       *triples[k]),
                    oracle(ix, s[k % len(s)], t[k % len(t)], *triples[k]))
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(37 * i,))
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors[0]


def test_the_server_calls_the_module_unwind_per_row(rooms_s, monkeypatch):
    """``query_paths`` unwinds each row through the module's
    ``unwind_path``, so a replacement sees every unwound row."""
    idx, s, t = rooms_s
    srv = _server(idx)
    seen = []

    def spy(*a):
        seen.append(a[3:])
        return unwind.unwind_path(*a)
    monkeypatch.setattr(serving_engine, "unwind_path", spy)
    srv.query_paths(s, t, host_index=idx)
    assert len(seen) == srv.stats.unwind_rows > 0
