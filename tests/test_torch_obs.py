"""The port's serving telemetry (``repro_torch.obs``, DESIGN.md §12) on the
CPU, against the reference's ``repro.obs``.

* The registry, the exporters and the stats views: one sequence of
  counter, gauge and histogram operations gives the same Prometheus text
  and JSON snapshot in both packages, and the text parses back.
* The serving series: the reference ``PathServer`` (jnp engine) and the
  port's (``backend="torch"``, ``device="cpu"``) serve the same seeded
  queries, synchronously and through each package's batcher; every
  bucket's row, the serve totals, the admission and flush counts and the
  stage histograms' counts agree (seconds are not compared).
* The span trees: sync and async traces carry every stage and telescope
  to their end-to-end time; a shed request and a superseded group leave
  their trace attributes and events; per-bucket rows restart per
  generation under load.
* The batcher closes out a group's stats before its tickets complete.
* The sharded engine's registry-backed per-shard counters equal the
  reference engine's on the same plan and traffic, and the plain counters
  the port reported before they moved onto the registry.
* The example's ``--metrics`` export.

Every server here records into a private registry unless the test is about
the process-wide one.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro import obs as ref_obs
from repro.core import packed as ref_packed
from repro.core.compression import compress_to_fraction as ref_compress
from repro.core.grid import build_ehl as ref_build_ehl
from repro.core.workload import uniform_queries as ref_uniform_queries
from repro.serving.batcher import CoalescingBatcher as RefCoalescingBatcher
from repro.serving.engine import PathServer as RefPathServer
from repro.serving.query_engine import make_engine as ref_make_engine
from repro.sharding import ShardedQueryEngine as RefShardedQueryEngine
from repro.sharding import ShardPlanner as RefShardPlanner
from repro_torch import obs
from repro_torch.core import (build_ehl, build_hub_labels, build_visgraph,
                              compress_to_fraction, make_map, pack_bucketed,
                              uniform_queries)
from repro_torch.serving import PathServer
from repro_torch.serving.batcher import CoalescingBatcher, QueueFull, Ticket
from repro_torch.sharding import ShardedQueryEngine, ShardPlanner

from test_torch_batcher import _KeyedEngine, _pts, _SwapDouble

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "pathfind_serve_torch.py"
REPO = pathlib.Path(__file__).resolve().parents[1]
# relative tolerance of a telescoping stage sum against its e2e time
TELESCOPE_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced(engine, **kw):
    """A port server over a private registry, every request sampled."""
    tel = obs.Telemetry(registry=obs.MetricsRegistry(), sample_rate=1.0)
    return PathServer(engine, telemetry=tel, **kw), tel


def _telescopes(tr) -> bool:
    return abs(tr.stage_sum - tr.e2e_seconds) \
        <= TELESCOPE_RTOL * tr.e2e_seconds


# ------------------------------------------------ registry, views, export

def _apply(reg, rng):
    """One seeded sequence of counter, gauge and histogram operations."""
    for i in range(12):
        reg.counter("ops_total", srv="s1", bucket=i % 3).inc(
            int(rng.integers(1, 9)))
    reg.counter("ops_total", srv="s2", bucket=0).inc(2.5)
    g = reg.gauge("depth", srv="s1")
    for v in rng.integers(0, 50, 6):
        g.set(int(v))
    reg.gauge("peak", srv="s1", gen=1).set(17)
    h = reg.histogram("lat_ms", stage="queue_wait", srv="s1")
    h.record_many(rng.lognormal(0.5, 1.0, 40).tolist())
    reg.histogram("lat_ms", stage="reply", srv="s1").record(0.125)
    reg.histogram("coarse_ms", bounds=np.array([1.0, 2.0, 4.0])).record_many(
        [0.5, 1.0, 3.0, 9.0])
    reg.counter("quoted_total", note='a "b"\nc').inc()


@pytest.mark.parametrize("seed", [0, 7])
def test_registry_exports_equal_reference(seed):
    """The same operations, under explicit labels, give identical
    Prometheus text and JSON snapshots in both packages, and the text
    parses back to every series' value."""
    ref, port = ref_obs.MetricsRegistry(), obs.MetricsRegistry()
    _apply(ref, np.random.default_rng(seed))
    _apply(port, np.random.default_rng(seed))
    text = obs.prometheus_text(port)
    assert text == ref_obs.prometheus_text(ref)
    assert obs.json_snapshot(port, run="x") == \
        ref_obs.json_snapshot(ref, run="x")
    parsed = obs.parse_prometheus(text)
    assert parsed == ref_obs.parse_prometheus(text)
    for m in port.metrics():
        if isinstance(m, obs.Histogram):
            assert parsed[m.name + "_count"][tuple(m.labels)] == m.count
            assert parsed[m.name + "_sum"][tuple(m.labels)] == \
                pytest.approx(m.sum, rel=1e-12)
        else:
            assert parsed[m.name][tuple(m.labels)] == m.value
    snap = json.loads(obs.json_snapshot(port, run="x"))
    assert snap["run"] == "x"
    with pytest.raises(ValueError):
        obs.parse_prometheus("ops_total{srv=\"s1\"} not-a-number\n")


def test_stats_view_fields_read_and_write_their_series():
    class Row(obs.StatsView):
        _COUNTERS = {"hits": ("row_hits_total", int),
                     "secs": ("row_seconds_total", float)}
        _GAUGES = {"depth": ("row_depth", int)}

        def __init__(self, registry):
            self._bind(registry, {"srv": "s9"}, row_prefix="r")

    reg = obs.MetricsRegistry()
    a, b = Row(reg), Row(reg)
    a.hits += 3
    a.hits += 2
    a.secs = 0.25
    a.depth = 7
    b.hits += 1
    assert (a.hits, a.secs, a.depth) == (5, 0.25, 7)
    assert isinstance(a.hits, int) and isinstance(a.secs, float)
    assert b.hits == 1 and a.labels["row"] != b.labels["row"]
    (s,) = reg.find("row_hits_total", row=a.labels["row"])
    assert s.value == 5
    assert a.counters() == {"hits": 5, "secs": 0.25, "depth": 7}
    a.hits = 0                                      # a reset is a set
    assert reg.find("row_hits_total", row=a.labels["row"])[0].value == 0
    assert "hits=0" in repr(a)


# ------------------------------------------------ serving series vs reference

@pytest.fixture(scope="module")
def port_rooms_s():
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


def _bucket_rows(stats) -> dict:
    return {k: (b.width, b.batches, b.queries, b.slots)
            for k, b in stats.per_bucket.items()}


def test_serving_series_equal_reference(port_rooms_s, compressed_s, scene_s,
                                        graph_s):
    """200 seeded queries at batch 32 through both servers: per bucket the
    width, batches, queries and slots, and the serve totals agree, in the
    views and in each package's Prometheus export."""
    qs = ref_uniform_queries(scene_s, graph_s, 200, seed=5,
                             require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    ref_tel = ref_obs.Telemetry(registry=ref_obs.MetricsRegistry())
    ref_srv = RefPathServer(
        ref_make_engine(ref_packed.pack_bucketed(compressed_s[0],
                                                 edge_grid=False),
                        backend="jnp"),
        batch_size=32, telemetry=ref_tel)
    srv, tel = _traced(pack_bucketed(port_rooms_s, device="cpu"),
                       batch_size=32, backend="torch", device="cpu")
    for server in (ref_srv, srv):
        server.query(s, t)
        server.query(s[:40], t[:40])
    assert _bucket_rows(srv.stats) == _bucket_rows(ref_srv.stats)
    assert len(srv.stats.per_bucket) >= 2
    for f in ("batches", "queries", "generation"):
        assert getattr(srv.stats, f) == getattr(ref_srv.stats, f), f
    assert srv.stats.queries == 240

    def exported(text):
        rows = {}
        for name in ("bucket_batches_total", "bucket_queries_total",
                     "bucket_slots_total", "bucket_width"):
            for lbl, v in obs.parse_prometheus(text)[name].items():
                d = dict(lbl)
                rows[(name, d["bucket"], d["gen"])] = v
        return rows

    assert exported(obs.prometheus_text(tel.registry)) == \
        exported(ref_obs.prometheus_text(ref_tel.registry))
    parsed = obs.parse_prometheus(obs.prometheus_text(tel.registry))
    assert sum(parsed["serve_queries_total"].values()) == 240
    assert sum(parsed["serve_batches_total"].values()) == srv.stats.batches


SERVE_COUNTS = ("submitted", "batches", "queries", "full_flushes",
                "deadline_flushes", "forced_flushes", "shed",
                "requeued_batches", "generation")
BUCKET_COUNTS = ("width", "admitted", "full_flushes", "deadline_flushes",
                 "batches", "queries", "slots")


def test_batcher_series_equal_reference(port_rooms_s, compressed_s, scene_s,
                                        graph_s):
    """The reference batcher and the port's take the same submits (one to
    nine queries each, 200 in all, batch 32), queued before the loop
    starts and flushed: the admission, flush and serve counts, every
    bucket's row, the ``stage_ms`` and ``request_latency_ms`` counts and
    the number of async traces are equal (seconds are not compared)."""
    qs = ref_uniform_queries(scene_s, graph_s, 200, seed=9,
                             require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    cuts = np.cumsum(np.random.default_rng(4).integers(1, 10, 60))
    cuts = [0] + [int(c) for c in cuts if c < 200] + [200]
    ref_tel = ref_obs.Telemetry(registry=ref_obs.MetricsRegistry(),
                                sample_rate=1.0)
    ref_srv = RefPathServer(
        ref_make_engine(ref_packed.pack_bucketed(compressed_s[0],
                                                 edge_grid=False),
                        backend="jnp"),
        batch_size=32, telemetry=ref_tel)
    srv, tel = _traced(pack_bucketed(port_rooms_s, device="cpu"),
                       batch_size=32, backend="torch", device="cpu")
    # no deadline flush: every partial group leaves on the flush
    for b in (RefCoalescingBatcher(ref_srv, autostart=False,
                                   max_wait_ms=600e3),
              CoalescingBatcher(srv, autostart=False, max_wait_ms=600e3)):
        tickets = [b.submit(s[a:z], t[a:z]) for a, z in zip(cuts, cuts[1:])]
        b.flush()
        b.start()
        assert b.drain(timeout=120)
        b.close()
        for tk in tickets:
            tk.result(timeout=1)
    for f in SERVE_COUNTS:
        assert getattr(srv.stats, f) == getattr(ref_srv.stats, f), f
    assert srv.stats.submitted == srv.stats.queries == 200
    assert srv.stats.full_flushes > 0 and srv.stats.forced_flushes > 0

    def rows(stats):
        return {k: tuple(getattr(b, f) for f in BUCKET_COUNTS)
                for k, b in stats.per_bucket.items()}

    assert rows(srv.stats) == rows(ref_srv.stats)
    assert len(srv.stats.per_bucket) >= 2

    def histogram_counts(reg):
        return {(m.name, dict(m.labels).get("stage")): m.count
                for name in ("stage_ms", "request_latency_ms")
                for m in reg.series(name)}

    got = histogram_counts(tel.registry)
    assert got == histogram_counts(ref_tel.registry)
    assert got[("stage_ms", "device_join")] == srv.stats.batches
    assert len(tel.spans.traces("async")) == \
        len(ref_tel.spans.traces("async")) >= len(cuts) - 1

    def exported(text):
        out = {}
        for name in ("bucket_admitted_total", "bucket_full_flushes_total",
                     "bucket_deadline_flushes_total",
                     "serve_submitted_total", "serve_forced_flushes_total"):
            for lbl, v in obs.parse_prometheus(text)[name].items():
                d = dict(lbl)
                out[(name, d.get("bucket"), d.get("gen"))] = v
        return out

    assert exported(obs.prometheus_text(tel.registry)) == \
        exported(ref_obs.prometheus_text(ref_tel.registry))


# --------------------------------------------------------------- spans

def test_sync_spans_complete_and_telescope():
    srv, tel = _traced(_KeyedEngine(), batch_size=8)
    xs = np.arange(12, dtype=np.float32)
    srv.query(_pts(xs), _pts(xs))
    srv.query(_pts(xs[:3]), _pts(xs[:3]))
    traces = tel.spans.traces("sync")
    assert len(traces) == 2
    for tr in traces:
        assert tr.closed and tr.complete(obs.SYNC_STAGES)
        assert tr.attrs["outcome"] == "ok" and tr.attrs["generation"] == 0
        assert tr.e2e_seconds > 0 and _telescopes(tr)
        assert [c["name"] for c in tr.tree()["children"]] == \
            list(obs.SYNC_STAGES)
    (h,) = tel.registry.find("sync_batch_ms")
    assert h.count == 2


def test_query_paths_span_has_unwind(port_rooms_s):
    """``query_paths`` stamps route, dispatch and unwind on a device
    engine; the tree is complete and telescopes."""
    scene = make_map("rooms-S", seed=1)
    qs = uniform_queries(scene, build_visgraph(scene), 24, seed=2)
    srv, tel = _traced(pack_bucketed(port_rooms_s, device="cpu"),
                       batch_size=16, backend="torch", device="cpu")
    srv.query_paths(qs.s, qs.t, host_index=port_rooms_s)
    (tr,) = tel.spans.traces("sync")
    assert tr.complete(obs.SYNC_STAGES) and _telescopes(tr)
    assert tr.attrs["argmin"] and tr.stages["unwind"] > 0
    assert tr.stages["route"] > 0 and tr.stages["dispatch"] > 0


def test_unsampled_sync_path_records_no_trace():
    tel = obs.Telemetry.off(registry=obs.MetricsRegistry())
    srv = PathServer(_KeyedEngine(), batch_size=8, telemetry=tel)
    xs = np.arange(5, dtype=np.float32)
    srv.query(_pts(xs), _pts(xs))
    assert tel.spans.traces() == []
    assert tel.registry.find("sync_batch_ms")[0].count == 1
    assert srv.stats.queries == 5


# ------------------------------------------- child spans below the stages

#: the child spans that sit directly under ``dispatch``
DISPATCH_CHILDREN = {"batch.assemble", "engine.upload", "engine.launch",
                     "engine.readback", "rescue", "batch.scatter"}
RESCUE_CHILDREN = {"rescue.residual", "rescue.upload", "rescue.join",
                   "rescue.splice"}
#: host-only spans and stages that a running profiler sees by name
ANNOTATED = {"route", "batch.assemble", "batch.scatter", "unwind"}


@pytest.fixture(scope="module")
def port_bx_s(port_rooms_s):
    from repro_torch.core.packed import slab_layout
    return {lay: pack_bucketed(port_rooms_s, device="cpu",
                               layout=slab_layout(lay))
            for lay in ("f32", "bf16")}


@pytest.fixture(scope="module")
def port_queries_s():
    scene = make_map("rooms-S", seed=1)
    qs = uniform_queries(scene, build_visgraph(scene), 80, seed=3)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


def _serve(srv, entry, s, t, host_index):
    if entry == "query_paths":
        return srv.query_paths(s, t, host_index=host_index)
    return srv.query(s, t)


@pytest.mark.parametrize("layout", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["query", "query_paths"])
def test_sampled_request_leaves_child_spans(entry, layout, port_bx_s,
                                            port_queries_s, port_rooms_s):
    """Every sampled sync request leaves child spans with its ``rid``,
    each inside its parent's interval (the trace's, for those under a
    stage), under ``dispatch`` or under ``rescue``; the children of
    ``dispatch`` sum to no more than it, the stages still telescope and the
    tree nests the spans below the stages."""
    from repro_torch.serving import TorchEngine

    s, t = port_queries_s
    srv, tel = _traced(TorchEngine(port_bx_s[layout]), batch_size=32)
    _serve(srv, entry, s, t, port_rooms_s)
    _serve(srv, entry, s[:20], t[:20], port_rooms_s)
    traces = tel.spans.traces("sync")
    assert len(traces) == 2 and traces[0].rid != traces[1].rid
    for tr in traces:
        assert tr.complete(obs.SYNC_STAGES) and _telescopes(tr)
        assert obs.current_trace() is None
        lo, hi = tr.t_start * 1e9 - 1e3, tr.t_end * 1e9 + 1e3
        for sp in tr.spans:
            assert sp.rid == tr.rid and sp.end_ns >= sp.start_ns
            if sp.up is None:
                assert sp.parent == "dispatch", sp.name
                assert sp.name in DISPATCH_CHILDREN
                assert lo <= sp.start_ns and sp.end_ns <= hi
            else:
                assert sp.parent == sp.up.name == "rescue"
                assert sp.name in RESCUE_CHILDREN
                assert sp.up.start_ns <= sp.start_ns
                assert sp.end_ns <= sp.up.end_ns
        names = {sp.name for sp in tr.spans}
        assert {"batch.assemble", "engine.upload", "engine.launch",
                "engine.readback", "batch.scatter"} <= names
        under = sum(sp.seconds for sp in tr.spans if sp.up is None)
        assert 0 < under <= tr.stages["dispatch"]
        kids = {c["name"]: c["children"] for c in tr.tree()["children"]}
        assert list(kids) == list(obs.SYNC_STAGES)
        assert {c["name"] for c in kids["dispatch"]} == \
            {sp.name for sp in tr.spans if sp.up is None}
        assert all(c["rid"] == tr.rid for c in kids["dispatch"])
        assert all(not kids[st] for st in obs.SYNC_STAGES
                   if st != "dispatch")
    rescued = [sp for tr in traces for sp in tr.spans if sp.name == "rescue"]
    if layout == "bf16" and entry == "query_paths":
        assert rescued
        for r in rescued:
            assert {c["name"] for c in _nested(traces, r)} == RESCUE_CHILDREN
    else:
        assert not rescued


def _nested(traces, span):
    return [sp.to_dict(0.0, []) for tr in traces for sp in tr.spans
            if sp.up is span]


def test_unsampled_request_records_no_span_and_opens_no_annotation(
        monkeypatch, port_bx_s, port_queries_s, port_rooms_s):
    """``Telemetry.off()``: under a running profiler a request leaves no
    trace, no child span and opens no annotation (the opener is counted);
    the same request sampled opens them."""
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import TorchEngine

    opened = []
    real = obs_trace._open_annotation
    monkeypatch.setattr(obs_trace, "_open_annotation",
                        lambda name: opened.append(name) or real(name))
    s, t = port_queries_s
    eng = TorchEngine(port_bx_s["bf16"])
    off = obs.Telemetry.off(registry=obs.MetricsRegistry())
    quiet = PathServer(eng, batch_size=32, telemetry=off)
    with torch.profiler.profile():
        quiet.query_paths(s, t, host_index=port_rooms_s)
        quiet.query(s, t)
    assert off.spans.traces() == [] and opened == []
    assert obs.current_trace() is None
    loud, tel = _traced(eng, batch_size=32)
    loud.query_paths(s, t, host_index=port_rooms_s)
    assert opened == []             # sampled, but no profiler running
    with torch.profiler.profile():
        loud.query_paths(s, t, host_index=port_rooms_s)
    assert ANNOTATED <= set(opened)
    assert not {"engine.upload", "engine.launch", "engine.readback",
                "rescue", "rescue.upload", "rescue.join"} & set(opened)


def test_profiler_host_events_carry_the_span_names(port_bx_s,
                                                   port_queries_s,
                                                   port_rooms_s):
    """Under a CPU ``torch.profiler`` the host events of a sampled
    ``query_paths`` include ``batch.assemble``, ``batch.scatter``,
    ``route`` and ``unwind``, each a user annotation."""
    from repro_torch.serving import TorchEngine

    s, t = port_queries_s
    srv, _ = _traced(TorchEngine(port_bx_s["f32"]), batch_size=32)
    with torch.profiler.profile() as prof:
        srv.query_paths(s, t, host_index=port_rooms_s)
    marks = {e.key for e in prof.events() if e.is_user_annotation}
    assert ANNOTATED <= marks
    assert not {"engine.upload", "engine.launch", "engine.readback"} & marks


def test_quantized_argmin_counts_its_rows(port_bx_s, port_queries_s):
    """A quantized argmin batch adds its slots (padding included) to
    ``argmin_rows_total`` and its flagged rows to ``rescue_rows_total``;
    an f32 engine's argmin batch adds to neither."""
    from repro_torch.core.packed import query_batch_at_bucket
    from repro_torch.serving import TorchEngine

    s, t = port_queries_s
    rows = 32

    def totals(name):
        return (obs.REGISTRY.total("argmin_rows_total", engine=name),
                obs.REGISTRY.total("rescue_rows_total", engine=name))

    eng = TorchEngine(port_bx_s["bf16"])
    keys = eng.buckets_of(s, t)
    flagged = []
    for k in np.unique(keys):
        sel = np.nonzero(keys == k)[0][:rows - 3]       # 3 padding slots
        sb = np.zeros((rows, 2), np.float32)
        tb = np.zeros((rows, 2), np.float32)
        sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
        amb = query_batch_at_bucket(eng.index, torch.from_numpy(sb),
                                    torch.from_numpy(tb), int(k),
                                    want_argmin=True)[5].numpy()
        before = totals(eng.name)
        eng.batch_argmin(sb, tb, int(k))
        after = totals(eng.name)
        assert after[0] - before[0] == rows
        assert after[1] - before[1] == int(np.count_nonzero(amb))
        flagged.append(int(np.count_nonzero(amb)))
    assert any(flagged)
    f32 = TorchEngine(port_bx_s["f32"])
    before = totals(f32.name)
    f32.batch_argmin(sb, tb, int(k))
    assert totals(f32.name) == before


def test_async_spans_complete_and_telescope():
    """Every request sampled: each trace has the whole async taxonomy and
    its stages sum to its end-to-end time; the stage histograms saw every
    retired group."""
    srv, tel = _traced(_KeyedEngine(), batch_size=8)
    b = CoalescingBatcher(srv, autostart=False)
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 64, size=48).astype(np.float32)
    tickets = [b.submit(_pts(xs[i:i + 3]), _pts(xs[i:i + 3]))
               for i in range(0, 48, 3)]
    b.start()
    b.flush()
    assert b.drain(timeout=10)
    b.close()
    for tk in tickets:
        tk.result(timeout=1)
        assert tk.completed_at >= tk.t_submit
    traces = tel.spans.traces("async")
    assert len(traces) >= len(tickets)
    for tr in traces:
        assert tr.closed and tr.complete(obs.ASYNC_STAGES)
        assert tr.e2e_seconds > 0 and _telescopes(tr)
        assert [c["name"] for c in tr.tree()["children"]] == \
            list(obs.ASYNC_STAGES)
        assert tr.attrs["outcome"] == "ok" and tr.attrs["requeues"] == 0
        assert tr.attrs["flush"] in ("full", "deadline", "forced")
    for st in ("queue_wait", "stage", "dispatch", "pipeline_wait",
               "device_join", "reply"):
        (h,) = tel.registry.find("stage_ms", stage=st)
        assert h.count == srv.stats.batches
    (lat,) = tel.registry.find("request_latency_ms")
    assert lat.count == len(traces)


def test_shed_request_traced_with_shed_outcome():
    srv, tel = _traced(_KeyedEngine(), batch_size=8)
    b = CoalescingBatcher(srv, autostart=False, max_queue=4, policy="shed")
    b.submit(_pts([0.0, 1.0]), _pts([0.0, 1.0]))
    with pytest.raises(QueueFull):
        b.submit(_pts([2.0, 3.0, 4.0]), _pts([2.0, 3.0, 4.0]))
    b.start()
    b.flush()
    b.drain(timeout=10)
    b.close()
    shed = [t for t in tel.spans.traces("async")
            if t.attrs["outcome"] == "shed"]
    assert len(shed) == 1
    assert shed[0].closed and shed[0].complete(obs.ASYNC_STAGES)
    assert _telescopes(shed[0])
    (ev,) = tel.events.events("shed")
    assert ev["n"] == 3 and ev["max_queue"] == 4
    assert srv.stats.shed == 3


def test_superseded_group_logs_requeue():
    """A group admitted under generation 0 and dispatched after a swap: a
    ``requeue`` event and a complete trace that carries the requeue."""
    old, new = _KeyedEngine(1.0), _KeyedEngine(2.0)
    sw = _SwapDouble(old)
    srv, tel = _traced(sw, batch_size=8)
    b = CoalescingBatcher(srv, autostart=False)
    xs = np.full(8, 4.0) + np.arange(8) * 4
    tk = b.submit(_pts(xs), _pts(xs))            # queued under gen 0
    sw.swap(new)                                 # published before dispatch
    b.start()
    np.testing.assert_array_equal(tk.result(timeout=10),
                                  xs.astype(np.float32) + 2000.0)
    b.close()
    (tr,) = tel.spans.traces("async")
    assert tr.complete(obs.ASYNC_STAGES) and _telescopes(tr)
    assert tr.attrs["requeues"] >= 1 and tr.attrs["generation"] == 1
    (ev,) = tel.events.events("requeue")
    assert (ev["from_gen"], ev["to_gen"], ev["n"]) == (0, 1, 8)
    assert srv.stats.requeued_batches == 1


def test_registry_series_reset_per_generation_under_load():
    """Per-bucket series are generation-tagged: after a swap the live rows
    restart at zero while the retired generation's stay frozen in the
    registry; the serve totals keep accumulating.  The batcher runs on its
    own thread throughout, so the counts are read as soon as a ticket
    completes."""
    old, new = _KeyedEngine(1.0), _KeyedEngine(2.0)
    sw = _SwapDouble(old)
    srv, tel = _traced(sw, batch_size=8)
    b = CoalescingBatcher(srv, autostart=True, max_wait_ms=2.0)
    xs = np.full(8, 4.0) + np.arange(8) * 4      # key 0, one full batch
    b.submit(_pts(xs), _pts(xs)).result(timeout=10)
    pb0 = srv.stats.per_bucket[0]
    assert pb0.queries == 8
    sw.swap(new)
    b.submit(_pts(xs), _pts(xs)).result(timeout=10)
    pb1 = srv.stats.per_bucket[0]
    assert srv.stats.queries == 16               # serve totals accumulate
    b.close()
    assert pb1 is not pb0                        # fresh row, new generation
    assert pb1.labels["gen"] == "1" and pb0.labels["gen"] == "0"
    assert pb1.queries == 8 and pb0.queries == 8
    assert srv.stats.swaps == 1
    gens = {dict(m.labels)["gen"]
            for m in tel.registry.series("bucket_queries_total")}
    assert gens == {"0", "1"}


def test_retire_counts_stats_before_tickets_complete(monkeypatch):
    """When a retired group's tickets are written, the group's queries are
    already in its bucket's and the server's rows: a caller woken by its
    ticket reads its own queries counted."""
    seen = []
    real_write = Ticket._write

    def spy(self, slots, cols):
        seen.append((srv.stats.per_bucket[0].queries, srv.stats.queries,
                     srv.stats.seconds > 0))
        real_write(self, slots, cols)

    monkeypatch.setattr(Ticket, "_write", spy)
    srv = PathServer(_KeyedEngine(), batch_size=8)
    b = CoalescingBatcher(srv, autostart=False)
    xs = np.full(8, 4.0) + np.arange(8) * 4      # key 0, one full batch
    tk = b.submit(_pts(xs), _pts(xs))
    b.start()
    tk.result(timeout=10)
    b.close()
    assert seen == [(8, 8, True)]


# --------------------------------------------------------------- sharded

# the per-shard (batches, slots, gathers_out, covis_assists) the sharded
# engine counted as plain attributes, before its counters moved onto the
# registry, on the traffic of the test below (rooms-S seed 1 at 0.3, four
# shards, batch 32): the sync pass, then query_paths, then the batcher.
# The reference engine counts the same on the same traffic.
PLAIN_SHARD_COUNTS = {
    "sync": [(7, 224, 128, 608), (7, 224, 192, 640), (5, 160, 160, 704),
             (8, 256, 160, 544)],
    "paths": [(12, 384, 256, 1088), (14, 448, 288, 1120),
              (9, 288, 288, 1248), (14, 448, 288, 960)],
    "async": [(19, 608, 384, 1696), (21, 672, 480, 1760),
              (14, 448, 448, 1952), (22, 704, 448, 1504)],
}
SHARD_SERIES = ("shard_batches_total", "shard_slots_total",
                "shard_gathers_out_total", "shard_covis_assists_total")


def _shard_counts(eng) -> list:
    return [(st.batches, st.slots, st.gathers_out, st.covis_assists)
            for st in eng.shard_stats()]


def _exported_shard_rows(parsed, eng) -> dict:
    """{series: {shard: value}} of one engine's rows in an export."""
    eng_id = eng.shard_stats()[0].labels["eng"]
    return {name: {dict(k)["shard"]: v for k, v in parsed[name].items()
                   if dict(k)["eng"] == eng_id} for name in SHARD_SERIES}


def test_sharded_series_equal_plain_counters(scene_s, graph_s, hl_s):
    """The reference ``ShardedQueryEngine`` behind the reference
    ``PathServer`` and the port's, on the same plan, queries and batch
    size: after the sync pass, ``query_paths`` and the batcher, every
    shard's batches, slots, gathers out and covis assists are equal, in
    the views and in each package's export, and equal to the plain
    counters the port reported before they moved onto the registry."""
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, 2.0, graph=graph, hl=build_hub_labels(graph))
    compress_to_fraction(idx, 0.3)
    eng = ShardedQueryEngine(ShardPlanner(4).build(idx, device="cpu"),
                             backend="torch")
    srv, tel = _traced(eng, batch_size=32)
    srv.warmup(paths=True)
    ref_idx = ref_build_ehl(scene_s, 2.0, graph=graph_s, hl=hl_s)
    ref_compress(ref_idx, 0.3)
    ref_eng = RefShardedQueryEngine(RefShardPlanner(4).build(ref_idx))
    ref_srv = RefPathServer(ref_eng, batch_size=32, telemetry=ref_obs.Telemetry(
        registry=ref_obs.MetricsRegistry(), sample_rate=1.0))
    qs = uniform_queries(scene, graph, 200, seed=3, require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)

    assert _shard_counts(eng) == [(0, 0, 0, 0)] * 4   # warmup is no traffic
    for server in (srv, ref_srv):
        server.query(s, t)
    assert _shard_counts(eng) == _shard_counts(ref_eng) \
        == PLAIN_SHARD_COUNTS["sync"]
    srv.query_paths(s[:64], t[:64], host_index=idx)
    ref_srv.query_paths(s[:64], t[:64], host_index=ref_idx)
    assert _shard_counts(eng) == _shard_counts(ref_eng) \
        == PLAIN_SHARD_COUNTS["paths"]
    for b in (CoalescingBatcher(srv, autostart=False),
              RefCoalescingBatcher(ref_srv, autostart=False)):
        for i in range(0, 200, 25):
            b.submit(s[i:i + 25], t[i:i + 25])
        b.flush()
        b.start()
        assert b.drain(timeout=120)
        b.close()
    assert _shard_counts(eng) == _shard_counts(ref_eng) \
        == PLAIN_SHARD_COUNTS["async"]
    assert srv.stats.per_shard is eng.shard_stats()
    # one exported row per shard and series, equal to the reference's
    parsed = obs.parse_prometheus(obs.prometheus_text(obs.REGISTRY))
    ref_parsed = ref_obs.parse_prometheus(
        ref_obs.prometheus_text(ref_obs.REGISTRY))
    rows = _exported_shard_rows(parsed, eng)
    assert rows == _exported_shard_rows(ref_parsed, ref_eng)
    for col, name in enumerate(SHARD_SERIES):
        assert rows[name] == {str(k): c[col] for k, c in
                              enumerate(PLAIN_SHARD_COUNTS["async"])}, name
    for st in eng.shard_stats():
        (g,) = obs.REGISTRY.find("shard_device_bytes", **st.labels)
        assert g.value == st.device_bytes
    eng.reset_serve_counters()
    assert _shard_counts(eng) == [(0, 0, 0, 0)] * 4


# --------------------------------------------------------------- example

def test_example_metrics_export(tmp_path):
    """``--metrics`` on the CPU: the example exits 0, its self-checks pass,
    and the exported ``serve_queries_total`` equals what it served."""
    out = tmp_path / "telemetry"
    proc = subprocess.run(
        [sys.executable, str(EXAMPLE), "--device", "cpu", "--map",
         "rooms-S", "--queries", "64", "--batch", "16", "--paths", "8",
         "--serve-async", "--metrics", "--metrics-dir", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    served = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("served in all: ")]
    assert len(served) == 1, proc.stdout
    n = int(served[0].split()[3])
    parsed = obs.parse_prometheus((out / "telemetry.prom").read_text())
    assert sum(parsed["serve_queries_total"].values()) == n > 64
    assert "entry_cold_total" in parsed
    snap = json.loads((out / "telemetry.json").read_text())
    assert snap["counters"]
    assert (out / "events.jsonl").exists()


def test_telemetry_threads_share_one_registry():
    """Two servers on two threads over one registry keep their rows apart
    (one ``srv`` label each)."""
    reg = obs.MetricsRegistry()
    servers = [PathServer(_KeyedEngine(), batch_size=8,
                          telemetry=obs.Telemetry(registry=reg))
               for _ in range(2)]
    xs = np.arange(20, dtype=np.float32)

    def work(srv):
        for _ in range(5):
            srv.query(_pts(xs), _pts(xs))

    threads = [threading.Thread(target=work, args=(srv,))
               for srv in servers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    rows = {dict(m.labels)["srv"]: m.value
            for m in reg.series("serve_queries_total")}
    assert sorted(rows.values()) == [100, 100] and len(rows) == 2
