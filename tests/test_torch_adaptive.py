"""The port's adaptive index lifecycle (``repro_torch.indexing``) on the CPU.

Three groups:

* the reference's ``tests/test_adaptive.py`` cases and its three
  build-trace cases (``tests/test_profile.py``), driven through the port's
  recorder, planner, swappable engine and manager (``backend="torch"``,
  ``device="cpu"``);
* parity with the reference on the same inputs (rooms-S seed 1, the same
  budgets, seeds and recorded traffic): the reference ``IndexManager``
  (jnp) and the port's take the same decisions with drift to 1e-12,
  produce the same regions, merges, label and device bytes, the same host
  mapper after every swap and the same probe set, and answer the probe set
  within rtol 1e-6 (f32) or within the quantization bounds (bf16);
* building blocks: the recorder's histogram and the workload generators
  against the reference, ``pack_bucketed(reuse_edges_from=)`` aliasing,
  the swappable engine's refused ``stage``, the batcher's recording, and
  the serving example's ``--adaptive`` and ``--clusters`` runs.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import workload as ref_workload
from repro.core.packed import bucketed_device_bytes as ref_device_bytes
from repro.indexing import IndexManager as RefManager
from repro.indexing import WorkloadRecorder as RefRecorder
from repro.serving.engine import expected_join_cost as ref_join_cost
from repro_torch import obs
from repro_torch.core import (build_ehl, build_hub_labels, build_visgraph,
                              bucketed_device_bytes, cluster_queries,
                              compress_to_device_budget, historical_workload,
                              make_clusters, make_map, mixed_queries,
                              pack_bucketed, uniform_queries,
                              workload_scores)
from repro_torch.indexing import (BudgetPlanner, IndexManager,
                                  SwappableEngine, WorkloadRecorder,
                                  engine_answers)
from repro_torch.serving import (PathServer, QueryEngine, TorchEngine,
                                 expected_join_cost)

EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "pathfind_serve_torch.py"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers on the machine's cores, where a default thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_s():
    """The port's own rooms-S seed 1 scene, visibility graph and hub
    labels (the reference's ``scene_s``/``graph_s``/``hl_s``)."""
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    return scene, graph, build_hub_labels(graph)


def fresh(port_s):
    scene, graph, hl = port_s
    return build_ehl(scene, 2.0, graph=graph, hl=hl)


def manager(port_s, fraction, **kw):
    idx = fresh(port_s)
    budget = int(bucketed_device_bytes(idx) * fraction)
    kw.setdefault("backend", "torch")
    kw.setdefault("device", "cpu")
    return IndexManager(idx, budget, **kw), budget


def clusters(port_s, n, seed):
    scene, graph, _ = port_s
    return cluster_queries(scene, graph, 2, n, seed=seed,
                           require_path=False)


# ---------------------------------------------------------------- recorder

def test_recorder_counts_decay_and_bounds():
    rec = WorkloadRecorder(nx=4, ny=4, cell_size=1.0, halflife=10.0)
    s = np.array([[0.5, 0.5], [3.5, 3.5]])
    t = np.array([[1.5, 0.5], [3.5, 0.5]])
    rec.record(s, t)
    w = rec.workload()
    assert w.shape == (16,)                      # bounded: one slot per cell
    assert rec.queries == 2
    assert w.sum() == pytest.approx(4.0)         # 4 endpoints, no decay yet
    assert w[0] == 1.0 and w[1] == 1.0           # s cells
    # out-of-bounds points clip into the grid instead of crashing
    rec.record(np.array([[99.0, -5.0]]), np.array([[2.2, 2.2]]))
    assert rec.workload().sum() == pytest.approx(
        4.0 * 0.5 ** (1 / 10.0) + 2.0)           # old mass aged one query
    d = rec.distribution()
    assert d.sum() == pytest.approx(1.0)
    rec.reset()
    assert rec.workload().sum() == 0.0 and rec.queries == 0
    # empty recorder -> uniform distribution, scores all-ones
    assert (rec.scores() == 1.0).all()
    assert rec.distribution().sum() == pytest.approx(1.0)


def test_recorder_shift_overtakes_history():
    rec = WorkloadRecorder(nx=2, ny=1, cell_size=1.0, halflife=50.0)
    left = (np.full((100, 2), 0.2), np.full((100, 2), 0.2))
    right = (np.full((100, 2), 1.8), np.full((100, 2), 1.8))
    for _ in range(3):
        rec.record(*left)
    for _ in range(6):
        rec.record(*right)
    w = rec.workload()
    assert w[1] > w[0]                           # shifted mass dominates


def test_recorder_histogram_equals_reference(scene_s, graph_s, ehl_s):
    """The float64 floor-divide, the decay and the clip give the
    reference's histogram and distribution, to 1e-12."""
    port = WorkloadRecorder.for_index(ehl_s, halflife=300.0)
    ref = RefRecorder.for_index(ehl_s, halflife=300.0)
    for seed in (3, 4, 5):
        qs = ref_workload.cluster_queries(scene_s, graph_s, 2, 120,
                                          seed=seed, require_path=False)
        pts = np.concatenate([qs.s, qs.t])
        pts[:4] = [[-3.0, 5.0], [1e4, 2.0], [4.0, 4.0], [0.0, 0.0]]
        for rec in (port, ref):
            rec.record(pts[:len(qs.s)], pts[len(qs.s):].astype(np.float32))
    assert port.queries == ref.queries
    np.testing.assert_allclose(port.workload(), ref.workload(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(port.distribution(), ref.distribution(),
                               rtol=1e-12, atol=1e-15)


# ----------------------------------------------------------- workloads

def test_workload_generators_equal_reference(scene_s, graph_s, ehl_s,
                                             port_s):
    """Same seed, same points: ``make_clusters``, ``cluster_queries``,
    ``mixed_queries``, ``historical_workload`` and ``workload_scores`` of
    the port equal the reference's bit for bit."""
    scene, graph, _ = port_s
    np.testing.assert_array_equal(
        make_clusters(scene, 3, np.random.default_rng(8)),
        ref_workload.make_clusters(scene_s, 3, np.random.default_rng(8)))
    for k, req in ((2, True), (3, False)):
        got = cluster_queries(scene, graph, k, 40, seed=9, require_path=req)
        want = ref_workload.cluster_queries(scene_s, graph_s, k, 40, seed=9,
                                            require_path=req)
        assert got.name == want.name
        np.testing.assert_array_equal(got.s, want.s)
        np.testing.assert_array_equal(got.t, want.t)
    uni = uniform_queries(scene, graph, 40, seed=2)
    mix = mixed_queries(got, uni, 0.7, seed=4)
    rmix = ref_workload.mixed_queries(
        want, ref_workload.uniform_queries(scene_s, graph_s, 40, seed=2),
        0.7, seed=4)
    assert mix.name == rmix.name
    np.testing.assert_array_equal(mix.s, rmix.s)
    np.testing.assert_array_equal(mix.t, rmix.t)
    np.testing.assert_array_equal(historical_workload(ehl_s, mix),
                                  ref_workload.historical_workload(ehl_s,
                                                                   rmix))
    np.testing.assert_array_equal(workload_scores(ehl_s, mix),
                                  ref_workload.workload_scores(ehl_s, rmix))


# ------------------------------------------------------------ swap engine

class _ConstEngine(QueryEngine):
    name = "const"

    def __init__(self, val):
        self.val = val

    def batch(self, s, t, bucket: int = 0):
        return np.full(len(s), self.val, np.float32)

    def device_bytes(self) -> int:
        return 100


def test_swappable_engine_generations_and_drain():
    a, b = _ConstEngine(1.0), _ConstEngine(2.0)
    sw = SwappableEngine(a)
    assert sw.generation == 0
    z = np.zeros((3, 2), np.float32)
    assert (sw.batch(z, z) == 1.0).all()

    cm = sw.pin()
    eng = cm.__enter__()                 # in-flight request pinned to gen 0
    assert eng is a
    sw.swap(b)
    assert sw.generation == 1 and sw.swaps == 1
    # the pinned request still runs on the old artifact...
    assert (eng.batch(z, z) == 1.0).all()
    # ...while new requests see the new one
    assert (sw.batch(z, z) == 2.0).all()
    assert sw.retired_generations() == [0]       # old engine parked, alive
    assert sw.drops == 0
    cm.__exit__(None, None, None)                # drain
    assert sw.retired_generations() == []
    assert sw.drops == 1                         # device buffers released

    # swap with nothing pinned drops the old engine immediately
    sw.swap(_ConstEngine(3.0))
    assert sw.drops == 2 and sw.generation == 2
    # index is never delegated: a long-lived holder would pin an artifact
    a.index = object()
    sw.swap(a)
    with pytest.raises(AttributeError):
        sw.index
    assert sw.artifact is a.index


def test_serve_stats_two_generation_reset():
    """First request on a new generation restarts per-bucket stats (bucket
    ids are meaningless across artifacts) and counts the swap."""
    a, b = _ConstEngine(1.0), _ConstEngine(2.0)
    sw = SwappableEngine(a)
    srv = PathServer(sw, batch_size=4)
    z = np.zeros((6, 2), np.float32)
    assert (srv.query(z, z) == 1.0).all()
    assert srv.stats.generation == 0 and srv.stats.swaps == 0
    pb0 = srv.stats.per_bucket[0]
    assert pb0.queries == 6

    sw.swap(b)
    assert srv.stats.swaps == 0          # observed at next dispatch, not eagerly
    assert (srv.query(z, z) == 2.0).all()
    assert srv.stats.generation == 1 and srv.stats.swaps == 1
    assert srv.stats.per_bucket[0] is not pb0    # reset, not accumulated
    assert srv.stats.per_bucket[0].queries == 6
    for bstats in srv.stats.per_bucket.values():
        assert bstats.occupancy <= 1.0


def test_serve_stats_stale_batches_mid_request_swap():
    """A swap published while a request is in flight: every batch of that
    request finishes on the pinned (now superseded) artifact and is counted
    stale; the generation advances only on the next request."""
    a, b = _ConstEngine(1.0), _ConstEngine(2.0)
    sw = SwappableEngine(a)
    fired = []
    orig = a.batch

    def batch_then_swap(s, t, bucket=0):
        out = orig(s, t, bucket)
        if not fired:
            fired.append(True)
            sw.swap(b)               # mid-request publish
        return out

    a.batch = batch_then_swap
    srv = PathServer(sw, batch_size=4)
    z = np.zeros((6, 2), np.float32)
    out = srv.query(z, z)
    assert (out == 1.0).all()        # the whole request served on its pin
    assert srv.stats.stale_batches == 2          # both batches superseded
    assert srv.stats.generation == 0             # generation it served on
    assert (srv.query(z, z) == 2.0).all()        # next request: new artifact
    assert srv.stats.swaps == 1 and srv.stats.generation == 1
    assert srv.stats.stale_batches == 2          # no new staleness


def test_swappable_stage_refused_batcher_stages_on_pin():
    """``stage``/``dispatch_staged`` on the swappable itself raise: a staged
    batch belongs to one generation.  The batcher stages and dispatches on
    the engine ``pin()`` yields, so it serves through a swappable, answers
    each group on the generation it pinned and records what it retires."""
    a, b = _ConstEngine(1.0), _ConstEngine(2.0)
    sw = SwappableEngine(a)
    z = np.zeros((4, 2), np.float32)
    with pytest.raises(TypeError):
        sw.stage(z, z)
    with pytest.raises(TypeError):
        sw.dispatch_staged((z, z))
    rec = WorkloadRecorder(nx=2, ny=2, cell_size=1.0)
    srv = PathServer(sw, batch_size=4, recorder=rec)
    pts = np.full((6, 2), 0.5, np.float32)
    assert (srv.submit(pts, pts).result(timeout=30) == 1.0).all()
    assert rec.queries == 6                      # recorded before result()
    sw.swap(b)
    assert (srv.submit(pts, pts).result(timeout=30) == 2.0).all()
    srv.stop_async()
    assert rec.queries == 12
    assert srv.stats.generation == 1 and srv.stats.swaps == 1


# ---------------------------------------------------------------- planner

def test_planner_decisions(port_s):
    scene, graph, _ = port_s
    idx = fresh(port_s)
    budget = int(bucketed_device_bytes(idx) * 0.5)
    compress_to_device_budget(idx, budget)
    rec = WorkloadRecorder.for_index(idx)
    pl = BudgetPlanner(budget, min_queries=50, replan_threshold=0.15)

    # too little traffic, artifact fits -> skip
    assert pl.decide(rec, idx).kind == "skip"
    # budget shrinks below the artifact -> incremental resume even with no
    # fresh traffic
    pl.set_budget(int(budget * 0.6))
    dec = pl.decide(rec, idx)
    assert dec.kind == "incremental"
    st = pl.execute(dec, idx, rec)
    assert st.device_bytes <= pl.device_budget_bytes
    assert bucketed_device_bytes(idx) <= pl.device_budget_bytes
    # now enough clustered traffic -> drift forces a replan
    qs = clusters(port_s, 80, seed=21)
    rec.record(qs.s, qs.t)
    dec2 = pl.decide(rec, idx)
    assert dec2.kind == "replan" and dec2.drift >= 0.15
    with pytest.raises(ValueError):
        pl.execute(dec2, idx, rec, base_snapshot=None)


class _FakeRecorder:
    """Drives decide() with a hand-set distribution (drift = TV distance)."""

    def __init__(self):
        self.queries = 0
        self._base = np.array([1.0, 0.0])
        self._dist = self._base.copy()

    def set_drift(self, x: float) -> None:
        """TV distance exactly ``x`` vs the last published distribution."""
        self._dist = self._base + np.array([-x, x])

    def rebase(self) -> None:
        """A plan was published from the current distribution."""
        self._base = self._dist.copy()

    def distribution(self) -> np.ndarray:
        return self._dist.copy()

    def scores(self) -> np.ndarray:
        return np.ones_like(self._dist)


def _publish(pl: BudgetPlanner, rec: _FakeRecorder) -> None:
    """Simulate a swapped candidate built from the current workload."""
    pl._pending = (rec.distribution(), rec.queries)
    pl.commit()
    rec.rebase()


def _planner(ehl_s, min_dwell, exit_threshold=0.05):
    budget = bucketed_device_bytes(ehl_s) * 2        # artifact always fits
    pl = BudgetPlanner(budget, min_queries=10, replan_threshold=0.15,
                       exit_threshold=exit_threshold, min_dwell=min_dwell)
    rec = _FakeRecorder()
    rec.queries = 20
    assert pl.decide(rec, ehl_s).kind == "replan"    # no baseline yet
    _publish(pl, rec)
    return pl, rec


def test_planner_min_dwell_stops_swap_churn(ehl_s):
    """Drift hovering at the replan threshold fires once per dwell window,
    not once per decision — the churn case the hysteresis exists for."""
    pl, rec = _planner(ehl_s, min_dwell=3)
    replans = 0
    for i in range(12):
        rec.set_drift(0.16 if i % 2 == 0 else 0.14)
        rec.queries += 20
        dec = pl.decide(rec, ehl_s)
        assert dec.kind in ("replan", "skip")
        if dec.kind == "replan":
            replans += 1
            _publish(pl, rec)
        else:
            assert "dwelling" in dec.reason
    assert replans == 3


def test_planner_alarm_latches_through_midband_dip(ehl_s):
    """A spike over the enter threshold during dwell still replans after
    the window even if drift has dipped into the (exit, enter) band."""
    pl, rec = _planner(ehl_s, min_dwell=2)
    rec.set_drift(0.20)                      # alarm raises, dwell blocks
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"
    rec.set_drift(0.10)                      # dip below enter: still latched
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "replan"    # dwell over, latched


def test_planner_exit_threshold_disarms(ehl_s):
    """Mid-band drift never replans unless the alarm was raised first, and
    falling to the exit threshold clears a raised alarm."""
    pl, rec = _planner(ehl_s, min_dwell=0)
    rec.set_drift(0.10)                      # mid-band, never alarmed
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"
    rec.set_drift(0.16)                      # alarm
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "replan"    # min_dwell=0: fires
    # NOT published (e.g. candidate aborted): alarm stays latched
    rec.set_drift(0.10)
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "replan"    # retry while latched
    rec.set_drift(0.04)                      # at/below exit: disarms
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"
    rec.set_drift(0.10)                      # mid-band again: still calm
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"


def test_planner_budget_overflow_bypasses_dwell(ehl_s):
    """Holding the device budget outranks churn control: an over-budget
    artifact triggers incremental even inside the dwell window."""
    pl, rec = _planner(ehl_s, min_dwell=5)
    rec.set_drift(0.20)                      # alarmed + dwelling
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "skip"
    pl.set_budget(1000)                      # budget collapses under artifact
    rec.queries += 20
    assert pl.decide(rec, ehl_s).kind == "incremental"


# ------------------------------------------------- manager / hot swap

@pytest.fixture(scope="module")
def adaptive_setup(port_s):
    mgr, budget = manager(port_s, 0.45, batch_size=32, min_queries=60,
                          replan_threshold=0.10, probe_n=32, seed=13)
    srv = PathServer(mgr.engine, batch_size=32, recorder=mgr.recorder)
    srv.warmup()
    return mgr, srv, budget


def test_hot_swap_answers_identical_and_budget_held(adaptive_setup, port_s):
    """The acceptance gate: a fixed probe set answers identically right
    before and right after a swap, and the swapped-in artifact fits the
    configured device-byte budget; its edge tensors are the previous
    artifact's own."""
    mgr, srv, budget = adaptive_setup
    assert mgr.device_bytes() <= budget          # initial fit

    qs = clusters(port_s, 150, seed=31)
    srv.query(qs.s.astype(np.float32), qs.t.astype(np.float32))
    assert mgr.recorder.queries == 150           # the server recorded it

    ps, pt = mgr.probe_set()
    d_before = mgr.probe_answers()
    _, paths_before = srv.query_paths(ps[:12], pt[:12],
                                      host_index=mgr.host_index)
    gen0 = mgr.generation
    edges0 = mgr.engine.artifact.edges_a

    assert mgr.maybe_adapt() is True             # swap published
    assert mgr.generation == gen0 + 1
    assert mgr.validation_failures == 0
    assert mgr.engine.artifact.edges_a is edges0     # aliased, not copied

    d_after = mgr.probe_answers()
    both_inf = ~np.isfinite(d_before) & ~np.isfinite(d_after)
    np.testing.assert_array_equal(np.where(both_inf, 0, d_before),
                                  np.where(both_inf, 0, d_after))
    assert mgr.device_bytes() <= budget          # budget survives the swap

    _, paths_after = srv.query_paths(ps[:12], pt[:12],
                                     host_index=mgr.host_index)
    for pb, pa in zip(paths_before, paths_after):
        assert len(pb) == len(pa)
        if len(pb):
            np.testing.assert_allclose(np.asarray(pb), np.asarray(pa),
                                       atol=1e-5)


def test_adaptive_join_cost_no_worse_than_uniform(port_s):
    """Post-swap expected join cost (mean dispatch-width^2) on a Cluster-x
    workload must be <= the uniform-score index at the same budget."""
    mgr, _ = manager(port_s, 0.35, batch_size=32, min_queries=60,
                     replan_threshold=0.10, probe_n=16, seed=3)
    uniform = mgr.engine.current

    qs = clusters(port_s, 200, seed=41)
    s = qs.s.astype(np.float32)
    t = qs.t.astype(np.float32)
    mgr.recorder.record(s, t)
    assert mgr.maybe_adapt() is True
    assert expected_join_cost(mgr.engine.current, s, t) <= \
        expected_join_cost(uniform, s, t)


def test_serve_stats_track_generation(adaptive_setup, port_s):
    mgr, srv, _ = adaptive_setup
    qs = clusters(port_s, 80, seed=51)
    srv.query(qs.s.astype(np.float32), qs.t.astype(np.float32))
    assert srv.stats.generation == mgr.generation
    assert srv.stats.swaps >= mgr.swaps - 1      # observed via dispatches


def test_background_adapt_thread(port_s):
    mgr, budget = manager(port_s, 0.5, batch_size=16, min_queries=40,
                          replan_threshold=0.10, probe_n=8, seed=29)
    qs = clusters(port_s, 60, seed=61)
    mgr.recorder.record(qs.s, qs.t)
    assert mgr.maybe_adapt(block=False) is False  # runs on the thread
    mgr.join(timeout=120.0)
    assert mgr.swaps == 1 and mgr.validation_failures == 0
    assert mgr.device_bytes() <= budget


def test_aborted_swap_rolls_back_mirror_and_planner(port_s):
    """A rejected candidate must leave no trace: host_index (the unwinding
    mirror of the live artifact) is restored and the planner keeps measuring
    drift against the last *published* plan, so adaptation retries instead
    of wedging on 'skip'."""
    mgr, budget = manager(port_s, 0.5, batch_size=16, min_queries=40,
                          replan_threshold=0.10, probe_n=8, seed=5)
    mapper_before = np.asarray(mgr.host_index.mapper).copy()
    n_regions = len(mgr.host_index.regions)

    # an unreachable budget: the candidate can never fit, so the budget
    # gate after probe validation must abort the swap
    mgr.set_budget(10_000)
    assert mgr.maybe_adapt() is False
    assert mgr.generation == 0 and mgr.swaps == 0
    assert mgr.validation_failures == 1
    assert mgr.history[-1].swapped is False
    assert "over device budget" in mgr.history[-1].abort_reason
    assert len(mgr.host_index.regions) == n_regions
    np.testing.assert_array_equal(np.asarray(mgr.host_index.mapper),
                                  mapper_before)
    assert mgr.planner.decide(mgr.recorder, mgr.host_index).kind != "skip"

    # restoring a feasible budget lets the same manager adapt normally
    mgr.set_budget(budget)
    qs = clusters(port_s, 60, seed=71)
    mgr.recorder.record(qs.s, qs.t)
    assert mgr.maybe_adapt() is True
    assert mgr.device_bytes() <= budget


def test_incremental_resume_preserves_answers(port_s, queries_s):
    """compress_incremental on an already-merged index keeps every answer
    (merging is correctness-preserving from any start state)."""
    from repro_torch.core.compression import (compress_incremental,
                                              compress_to_fraction)
    from repro_torch.core.query import query

    idx = fresh(port_s)
    compress_to_fraction(idx, 0.5)
    truth = [query(idx, s, t, want_path=False)[0]
             for s, t in zip(queries_s.s[:15], queries_s.t[:15])]
    st = compress_incremental(idx, int(idx.label_memory() * 0.5))
    assert st.merges > 0
    assert st.final_bytes <= st.budget or st.hit_single_region
    for (s, t), d0 in zip(zip(queries_s.s[:15], queries_s.t[:15]), truth):
        d, _ = query(idx, s, t, want_path=False)
        assert d == pytest.approx(d0, abs=1e-8)


def test_manager_signature_and_device(port_s):
    """``num_shards > 1`` takes the sharded branch (a budget below the
    shards' replicated overhead is refused as infeasible); a non-packed
    backend is refused; the entry point defaults to the card."""
    with pytest.raises(ValueError, match="infeasible for 2 shards"):
        IndexManager(fresh(port_s), 1, backend="torch", device="cpu",
                     num_shards=2)
    idx = object()
    with pytest.raises(ValueError, match="torch|cuda"):
        IndexManager(idx, 1, backend="host", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        IndexManager(idx, 1)


# ----------------------------------------------- build-pipeline spans

@pytest.fixture()
def traced_manager(port_s):
    tel = obs.Telemetry(registry=obs.MetricsRegistry(), sample_rate=1.0)
    mgr, budget = manager(port_s, 0.5, batch_size=16, min_queries=40,
                          replan_threshold=0.10, probe_n=8, seed=29,
                          telemetry=tel)
    return mgr, tel, budget


def test_build_stage_spans_telescope_to_e2e(traced_manager, port_s):
    mgr, tel, _ = traced_manager
    qs = clusters(port_s, 60, seed=61)
    mgr.recorder.record(qs.s, qs.t)
    assert mgr.maybe_adapt() is True

    (tr,) = tel.spans.traces("build")
    assert tr.closed and tr.complete(obs.BUILD_STAGES)
    assert tr.attrs["outcome"] == "ok"
    assert [c["name"] for c in tr.tree()["children"]] == \
        list(obs.BUILD_STAGES)
    assert tr.e2e_seconds > 0
    assert abs(tr.stage_sum - tr.e2e_seconds) <= 1e-6 * tr.e2e_seconds
    reg = tel.registry
    for st in obs.BUILD_STAGES:
        (h,) = reg.find("build_stage_ms", stage=st)
        assert h.count == 1
    (ok,) = reg.find("builds_total", outcome="ok")
    assert ok.value == 1
    (dec,) = tel.events.events("plan_decision")
    assert dec["decision"] != "skip" and dec["budget_bytes"] > 0
    (ex,) = tel.events.events("plan_execute")
    assert ex["regions_in"] == ex["regions_admitted"] + ex["regions_evicted"]
    assert ex["label_bytes_out"] <= ex["label_bytes_in"]
    (sw,) = tel.events.events("swap")
    assert sw["generation"] == 1 and sw["device_bytes"] == mgr.device_bytes()


def test_async_build_span_covers_hot_swap_under_serving(traced_manager,
                                                        port_s):
    """A background build (hot-swap mid-serving): the span is produced on
    the build thread and still telescopes; the foreground keeps serving
    through the swap."""
    mgr, tel, budget = traced_manager
    srv = PathServer(mgr.engine, batch_size=16, recorder=mgr.recorder)
    srv.warmup()
    qs = clusters(port_s, 60, seed=91)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    want = srv.query(s, t)
    gen0 = mgr.generation
    assert mgr.maybe_adapt(block=False) is False   # builds on the thread
    np.testing.assert_allclose(srv.query(s, t), want, rtol=1e-6)   # during
    mgr.join(timeout=120.0)
    assert mgr.generation == gen0 + 1 and mgr.swaps == 1
    np.testing.assert_allclose(srv.query(s, t), want, rtol=1e-6)   # after

    (tr,) = tel.spans.traces("build")
    assert tr.complete(obs.BUILD_STAGES) and tr.attrs["outcome"] == "ok"
    assert tr.attrs["async_build"] is True
    assert abs(tr.stage_sum - tr.e2e_seconds) <= 1e-6 * tr.e2e_seconds
    assert tr.attrs["generation"] == mgr.generation
    assert tr.attrs["device_bytes_out"] <= budget
    assert tr.attrs["regions_out"] <= tr.attrs["regions_in"]


def test_aborted_build_traced_with_abort_outcome(traced_manager):
    mgr, tel, budget = traced_manager
    mgr.set_budget(10_000)                       # no candidate can fit
    assert mgr.maybe_adapt() is False
    (tr,) = tel.spans.traces("build")
    assert tr.closed and tr.complete(obs.BUILD_STAGES)
    assert tr.attrs["outcome"] == "abort"
    assert abs(tr.stage_sum - tr.e2e_seconds) <= 1e-6 * tr.e2e_seconds
    (ab,) = tel.registry.find("builds_total", outcome="abort")
    assert ab.value == 1
    assert not tel.registry.find("builds_total", outcome="ok")
    (ev,) = tel.events.events("swap_abort")
    assert "over device budget" in ev["abort_reason"]


# ------------------------------------------- parity with the reference

def _mirror(layout, fraction, scene_s, graph_s, hl_s, port_s):
    """The reference manager (jnp) and the port's on the same uncompressed
    rooms-S index, budget, seed and settings."""
    from repro.core.grid import build_ehl as ref_build_ehl

    ref_idx = ref_build_ehl(scene_s, 2.0, graph=graph_s, hl=hl_s)
    budget = int(ref_device_bytes(ref_idx) * fraction)
    kw = dict(batch_size=32, min_queries=60, replan_threshold=0.10,
              min_dwell=1, probe_n=16, seed=19, validate_tol=0.0,
              layout=layout)
    ref = RefManager(ref_idx, budget, backend="jnp", **kw)
    port = IndexManager(fresh(port_s), budget, backend="torch",
                        device="cpu", **kw)
    return ref, port


def _probe_tol(ref, port):
    """Probe answers of the two packages: rtol 1e-6 on f32; on a quantized
    layout each side lies within 2·qerr of the exact answer."""
    qr = float(np.asarray(ref.engine.artifact.qerr)) \
        if ref.layout.quantized else 0.0
    return 2.0 * (qr + port._qerr_of(port.engine.artifact))


# traffic seeds per adaptation step; None shrinks the budget instead.  f32:
# replan, dwell (skip), replan after the shift, incremental resume; bf16:
# replan, dwell, incremental (every generation costs the reference a jit
# compile per bucket shape, so the bf16 schedule is the shorter one)
SCHEDULES = {None: [31, 31, 202, None], "bf16": [31, 31, None]}
KINDS = {None: ["replan", "replan", "incremental"],
         "bf16": ["replan", "incremental"]}


@pytest.mark.parametrize("layout,fraction", [(None, 0.45), ("bf16", 0.2)])
def test_manager_parity_with_reference(layout, fraction, scene_s, graph_s,
                                       hl_s, port_s):
    """Same inputs through both managers: the same decisions (drift to
    1e-12), swap records, host mapper, probe set, probe answers and
    expected join cost, over a schedule of replans, a dwelling skip and an
    incremental resume under a shrunk budget."""
    ref, port = _mirror(layout, fraction, scene_s, graph_s, hl_s, port_s)
    assert port.device_budget_bytes() == ref.device_budget_bytes()
    assert port.device_bytes() == ref.device_bytes()
    for a, b in zip(port.probe_set(), ref.probe_set()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for step, seed in enumerate(SCHEDULES[layout]):
        if seed is None:
            shrunk = int(ref.device_bytes() * 0.9)
            ref.set_budget(shrunk)
            port.set_budget(shrunk)
        else:
            qs = ref_workload.cluster_queries(scene_s, graph_s, 2, 90,
                                              seed=seed, require_path=False)
            keep = rng.random(len(qs.s)) < 0.9   # not the same twice
            for m in (ref, port):
                m.recorder.record(qs.s[keep], qs.t[keep])
        assert port.planner.drift(port.recorder) == pytest.approx(
            ref.planner.drift(ref.recorder), abs=1e-12)
        got, want = port.maybe_adapt(), ref.maybe_adapt()
        assert got == want, f"step {step}"
        assert len(port.history) == len(ref.history)
        if not port.history:
            continue
        p, r = port.history[-1], ref.history[-1]
        assert (p.kind, p.swapped, p.generation) == \
            (r.kind, r.swapped, r.generation), f"step {step}"
        assert p.drift == pytest.approx(r.drift, abs=1e-12)
        assert (p.regions, p.merges, p.label_bytes, p.device_bytes) == \
            (r.regions, r.merges, r.label_bytes, r.device_bytes)
        np.testing.assert_array_equal(np.asarray(port.host_index.mapper),
                                      np.asarray(ref.host_index.mapper))
        assert port.device_bytes() == ref.device_bytes()
        dp, dr = port.probe_answers(), ref.probe_answers()
        np.testing.assert_array_equal(np.isfinite(dp), np.isfinite(dr))
        fin = np.isfinite(dr)
        np.testing.assert_allclose(dp[fin], dr[fin], rtol=1e-6,
                                   atol=_probe_tol(ref, port))
    kinds = [h.kind for h in port.history]
    assert kinds == KINDS[layout] and port.swaps == len(kinds)
    assert port.validation_failures == ref.validation_failures == 0
    qs = ref_workload.cluster_queries(scene_s, graph_s, 2, 90, seed=202,
                                      require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    assert expected_join_cost(port.engine.current, s, t) == \
        ref_join_cost(ref.engine.current, s, t)
    assert [r.kind for r in ref.history] == kinds


# ------------------------------------------------------ repack fast path

@pytest.mark.parametrize("case", ["dense", "grid"])
def test_reuse_edges_aliases_and_answers_equal(case, port_s):
    """``pack_bucketed(reuse_edges_from=)`` aliases the previous artifact's
    edge tensors and grid (no copy), from a bucketed or a single-slab
    artifact, keeps its grid decision, and answers as a fresh pack does,
    bit for bit: rooms-S seed 1 stays dense, rooms-S seed 0 carries the
    auto policy's edge grid."""
    from repro_torch.core import compress_to_fraction, pack_index

    if case == "dense":
        scene, graph, _ = port_s
        idx = fresh(port_s)
    else:
        scene = make_map("rooms-S", seed=0)
        graph = build_visgraph(scene)
        idx = build_ehl(scene, 2.0, graph=graph)
    prev = pack_bucketed(idx, device="cpu")
    assert (prev.grid is not None) == (case == "grid")
    compress_to_fraction(idx, 0.3)
    for src in (prev, pack_index(idx, edge_grid=prev.grid is not None,
                                 device="cpu")):
        bx = pack_bucketed(idx, reuse_edges_from=src, device="cpu")
        for k in ("edges_a", "edges_b", "edges_c"):
            assert getattr(bx, k).data_ptr() == getattr(src, k).data_ptr()
        assert bx.grid is src.grid
    fresh_bx = pack_bucketed(idx, device="cpu")
    assert bx.device_bytes() == fresh_bx.device_bytes()
    qs = uniform_queries(scene, graph, 48, seed=5, require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    got = PathServer(TorchEngine(bx), batch_size=16)._dispatch(
        s, t, want_argmin=True)
    want = PathServer(TorchEngine(fresh_bx), batch_size=16)._dispatch(
        s, t, want_argmin=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(engine_answers(TorchEngine(bx), s, t),
                                  got[0])
    with pytest.raises(ValueError, match="lives on"):
        pack_bucketed(idx, reuse_edges_from=prev, device="meta")


# ------------------------------------------------------------- example

def _example():
    spec = importlib.util.spec_from_file_location("pathfind_serve_torch",
                                                  EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def test_adaptive_example_runs_on_cpu(capsys):
    """The reference's documented ``--adaptive`` invocation on the CPU
    twins swaps at least once with answers stable and the budget held, and
    its async pass on the final generation equals the sync one."""
    rc = _example().main(["--device", "cpu", "--adaptive", "--map",
                          "rooms-S", "--queries", "96", "--batch", "32",
                          "--budget", "0.4", "--rounds", "6",
                          "--serve-async"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "adaptive smoke OK" in out and "identical=yes" in out
    assert "SWAP[replan]" in out


def test_clusters_example_runs_on_cpu(capsys):
    rc = _example().main(["--device", "cpu", "--map", "rooms-S",
                          "--queries", "32", "--batch", "16", "--clusters",
                          "2", "--backend", "torch"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "workload-aware=True" in out
