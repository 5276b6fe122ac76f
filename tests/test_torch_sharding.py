"""The port's region sharding (``repro_torch.sharding``) on the CPU.

Against the reference (rooms-S seed 1 at budget 0.3, four shards, the
fixtures of ``tests/conftest.py``): the planner's placement, the split
packer's per-shard planes, edge masks, owned rects, routing arrays and byte
counts, the router's keys, the cross-shard entries and the sharded
manager's decisions must equal the reference's; served answers are held
against the reference's unpadded single-device ``query_batch_bucketed``
(rtol 1e-6, argmin ids equal except at its ties), never against its
sharded or padded-server outputs, which differ from its own single-device
answers by an ulp (ROADMAP queue 3).

Inside the port: the sharded engine equals the port's single-device
bucketed engine bit for bit (distances and all 5 argmin outputs) through
``query``, ``PathServer`` and the batcher; the quantized wire decodes to the
owner-side fold bit for bit; the per-shard clip keeps answers exact on an
occluded map at 12 shards; point location at cell 3.0 (not a power of two)
agrees between the host router and every shard's device mapper; the
manager swaps every shard under one generation and aborts a candidate
over its per-shard cap.  Shards round-robin onto the CPU (``device="cpu"``).
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import packed as ref_packed
from repro.core.compression import compress_to_fraction as ref_compress
from repro.core.grid import build_ehl as ref_build_ehl
from repro.core.workload import cluster_queries as ref_cluster_queries
from repro.core.workload import uniform_queries as ref_uniform_queries
from repro.indexing import IndexManager as RefManager
from repro.serving.shard_router import ShardRouter as RefRouter
from repro.sharding import ShardPlanner as RefPlanner
from repro.sharding import region_centroids as ref_region_centroids
from repro.sharding import sharded_overhead_bytes as ref_overhead
from repro_torch.core import (build_ehl, build_hub_labels, build_visgraph,
                              bucketed_device_bytes, cluster_queries,
                              compress_to_fraction, make_map, pack_bucketed,
                              query_batch_bucketed, slab_layout,
                              uniform_queries)
from repro_torch.core import packed as port_packed
from repro_torch.indexing import IndexManager
from repro_torch.kernels import ref as port_ref
from repro_torch.launch.mesh import make_serving_mesh, shard_devices
from repro_torch.serving import PathServer
from repro_torch.sharding import (ShardedIndex, ShardedQueryEngine,
                                  ShardPlanner, region_centroids,
                                  shard_imbalance, sharded_overhead_bytes)

from test_torch_cuda import cell3_case, check_cell3_sharded
from test_torch_packed import PLANES, STATIC, grid_planes
from test_torch_quantized import bits
from test_torch_serving import assert_matches_reference, tied_rows

N_SHARDS = 4
FRACTION = 0.3
ANSWERS = ("d", "covis", "via_s", "hub", "via_t")
# the reference's CPU sizing of this configuration (f32): per-shard device
# bytes and clipped edges kept
SIZING_BYTES = [160744, 160728, 160744, 191536]
SIZING_KEPT = [32, 32, 32, 31]
EXAMPLE = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "pathfind_serve_torch.py"
CASES = [("f32", None), ("bf16", None), ("f32", True)]


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
    """The port's own rooms-S seed 1 scene, graph and hub labels."""
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    return scene, graph, build_hub_labels(graph)


@pytest.fixture(scope="module")
def port_idx(port_s):
    scene, graph, hl = port_s
    idx = build_ehl(scene, 2.0, graph=graph, hl=hl)
    compress_to_fraction(idx, FRACTION)
    return idx


@pytest.fixture(scope="module")
def ref_idx(scene_s, graph_s, hl_s):
    idx = ref_build_ehl(scene_s, 2.0, graph=graph_s, hl=hl_s)
    ref_compress(idx, FRACTION)
    return idx


@pytest.fixture(scope="module")
def port_bx(port_idx):
    return pack_bucketed(port_idx, device="cpu")


@pytest.fixture(scope="module")
def port_sharded(port_idx):
    """{(layout, edge_grid): the port's sharded artifact on the CPU}."""
    return {(lay, g): ShardPlanner(N_SHARDS, layout=slab_layout(lay)).build(
        port_idx, edge_grid=g, device="cpu") for lay, g in CASES}


@pytest.fixture(scope="module")
def ref_sharded(ref_idx):
    return {(lay, g): RefPlanner(
        N_SHARDS, layout=ref_packed.slab_layout(lay)).build(ref_idx,
                                                            edge_grid=g)
        for lay, g in CASES}


@pytest.fixture(scope="module")
def queries(scene_s, graph_s):
    qs = ref_uniform_queries(scene_s, graph_s, 160, seed=3,
                             require_path=False)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


def _cross_key(eng, s, t):
    """The busiest cross-shard routing key of a batch, at its widest
    width."""
    keys = eng.buckets_of(s, t)
    cross = [k for k in np.unique(keys)
             if eng.router.decode_key(k)[0] != eng.router.decode_key(k)[1]]
    assert cross, "no cross-shard traffic routed"
    return max(cross, key=lambda k: (eng.bucket_width(k),
                                     int((keys == k).sum())))


# ---------------------------------------------------------------- planner

@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_planner_equals_reference(layout, port_idx, ref_idx):
    """Morton bin-pack + rebalance: the same assignment, predicted slab
    bytes, moves and imbalance as the reference's planner (numpy both)."""
    got = ShardPlanner(N_SHARDS, layout=slab_layout(layout)).plan(port_idx)
    want = RefPlanner(N_SHARDS,
                      layout=ref_packed.slab_layout(layout)).plan(ref_idx)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    np.testing.assert_array_equal(got.slab_bytes, want.slab_bytes)
    assert (got.moves, got.tol, got.num_shards) == \
        (want.moves, want.tol, want.num_shards)
    assert got.imbalance == want.imbalance <= got.tol
    np.testing.assert_array_equal(region_centroids(port_idx),
                                  ref_region_centroids(ref_idx))


def test_planner_rejects_more_shards_than_regions(port_s):
    scene, graph, hl = port_s
    idx = build_ehl(scene, 2.0, graph=graph, hl=hl)
    with pytest.raises(ValueError, match="cannot fill"):
        ShardPlanner(10 ** 6).plan(idx)
    with pytest.raises(ValueError):
        ShardPlanner(0)


# ------------------------------------------------------------ split packer

def _shard_planes(bx) -> dict:
    """A shard's fields as numpy (2-byte planes as their uint16 bits)."""
    out = {k: [bits(a if isinstance(a, np.ndarray) else
                    (a if isinstance(a, torch.Tensor) else np.asarray(a)))
               for a in getattr(bx, k)]
           for k in ("hub_ids", "via_xy", "via_d", "via_ids", "hub_base",
                     "vid_base")}
    out.update({k: bits(getattr(bx, k) if isinstance(getattr(bx, k),
                                                     torch.Tensor)
                        else np.asarray(getattr(bx, k))) for k in PLANES})
    out.update({k: getattr(bx, k) for k in STATIC})
    out["grid"] = grid_planes(bx.grid)
    if bx.vert_xy is not None:
        out["vert_xy"] = bits(bx.vert_xy if isinstance(bx.vert_xy,
                                                       torch.Tensor)
                              else np.asarray(bx.vert_xy))
        out["qerr"] = float(np.asarray(bx.qerr) if not isinstance(
            bx.qerr, torch.Tensor) else bx.qerr)
        out["residual"] = [np.asarray(d) for d in bx.residual.d]
    return out


@pytest.mark.parametrize("layout,edge_grid", CASES)
def test_split_packer_equals_reference(layout, edge_grid, port_sharded,
                                       ref_sharded, port_idx, ref_idx):
    """Per-shard slabs (planes, bucket ladders, quantized extras, residual
    rows, clipped edges, per-subset grids), edge masks, owned rects, the
    routing arrays and every byte count equal the reference's."""
    got = port_sharded[(layout, edge_grid)]
    want = ref_sharded[(layout, edge_grid)]
    assert isinstance(got, ShardedIndex)
    for k, (a, b) in enumerate(zip(got.shards, want.shards)):
        pa, pb = _shard_planes(a), _shard_planes(b)
        assert pa.keys() == pb.keys()
        for name in pa:
            if isinstance(pa[name], list):
                assert len(pa[name]) == len(pb[name]), (k, name)
                for x, y in zip(pa[name], pb[name]):
                    np.testing.assert_array_equal(x, y, err_msg=f"{k} {name}")
            elif isinstance(pa[name], dict):
                assert pa[name].keys() == pb[name].keys()
                for g in pa[name]:
                    np.testing.assert_array_equal(pa[name][g], pb[name][g])
            elif isinstance(pa[name], np.ndarray):
                np.testing.assert_array_equal(pa[name], pb[name],
                                              err_msg=f"{k} {name}")
            else:
                assert pa[name] == pb[name], (k, name)
        assert a.num_regions == b.num_regions
        assert a.label_slots() == b.label_slots()
        assert a.bucket_stats() == b.bucket_stats()
    for name in ("region_shard", "region_local", "cell_shard", "cell_local",
                 "cell_bucket", "cell_row", "cell_width", "shard_rects"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for a, b in zip(got.edge_masks, want.edge_masks):
        np.testing.assert_array_equal(a, b)
    assert got.width_classes == want.width_classes
    assert got.per_shard_bytes() == want.per_shard_bytes()
    assert got.device_bytes() == want.device_bytes()
    assert got.edge_bytes() == want.edge_bytes()
    assert got.imbalance() == want.imbalance()
    assert got.bucket_stats() == want.bucket_stats()
    lay = slab_layout(layout)
    assert sharded_overhead_bytes(port_idx, N_SHARDS, layout=lay) == \
        ref_overhead(ref_idx, N_SHARDS, layout=ref_packed.slab_layout(layout))
    if (layout, edge_grid) == ("f32", None):
        assert got.per_shard_bytes() == SIZING_BYTES
        assert [int(m.sum()) for m in got.edge_masks] == SIZING_KEPT
    if edge_grid:
        assert all(bx.grid is not None for bx in got.shards)


def test_split_packer_aliases_unchanged_clips(port_s):
    """The repack fast path: a shard whose clip mask is unchanged aliases
    the previous generation's edge tensors and grid; a changed mask packs
    anew; an artifact on another device is refused."""
    scene, graph, hl = port_s
    idx = build_ehl(scene, 2.0, graph=graph, hl=hl)
    compress_to_fraction(idx, 0.5)
    planner = ShardPlanner(N_SHARDS)
    prev = planner.build(idx, edge_grid=True, device="cpu")
    compress_to_fraction(idx, 0.4)
    new = planner.build(idx, plan=planner.plan(idx), reuse_edges_from=prev,
                        edge_grid=True, device="cpu")
    fresh = planner.build(idx, edge_grid=True, device="cpu")
    same = 0
    for a, b, ma, mb in zip(new.shards, prev.shards, new.edge_masks,
                            prev.edge_masks):
        aliased = a.edges_a.data_ptr() == b.edges_a.data_ptr()
        assert aliased == np.array_equal(ma, mb)
        assert (a.grid is b.grid) == aliased
        same += aliased
    assert same > 0
    assert new.per_shard_bytes() == fresh.per_shard_bytes()


# ---------------------------------------------------------------- routing

def test_route_keys_equal_reference(port_sharded, ref_sharded, queries):
    """Host routing: composite keys, their decoding, the covis participants
    of every batch and the clipped local ids equal the reference router's."""
    s, t = queries
    eng = ShardedQueryEngine(port_sharded[("f32", None)], backend="torch")
    ref = RefRouter(ref_sharded[("f32", None)])
    keys = eng.buckets_of(s, t)
    np.testing.assert_array_equal(keys, ref.route_keys(s, t))
    for k in np.unique(keys):
        assert eng.router.decode_key(k) == ref.decode_key(k)
        assert eng.bucket_width(k) == ref.key_width(k)
        m = keys == k
        assert eng.router.covis_shards(s[m], t[m]) == \
            ref.covis_shards(s[m], t[m])
        i, j, _ = ref.decode_key(k)
        st = eng.router.stage(s[m], t[m], int(k))
        np.testing.assert_array_equal(
            st.loc_s.numpy(), np.asarray(ref._locals(ref._cells(s[m]), i)))
        np.testing.assert_array_equal(
            st.loc_t.numpy(), np.asarray(ref._locals(ref._cells(t[m]), j)))
    # zero-padding rows are left out of the covis bbox
    z = np.zeros((5, 2), np.float32)
    assert eng.router.covis_shards(z, z) == ref.covis_shards(z, z) == []
    assert eng.num_buckets == N_SHARDS ** 2 * len(
        port_sharded[("f32", None)].width_classes)


def _ties(masked_s, masked_t, rtol=1e-6) -> np.ndarray:
    """[B] rows whose join has a second candidate within ``rtol`` of the
    winner (for i over the row join, or for j at the winning hub)."""
    hs, vs, _ = masked_s
    ht, vt, _ = masked_t
    rowmin = port_ref.label_join_rowmin_ref(hs, vs, ht, vt)
    best = rowmin.amin(-1, keepdim=True)
    near_i = (rowmin <= best * (1 + rtol)) & torch.isfinite(rowmin)
    hub_i = torch.gather(hs, 1, rowmin.argmin(-1, keepdim=True))
    cand = torch.where(ht == hub_i, vt, torch.tensor(float("inf")))
    near_j = (cand <= cand.amin(-1, keepdim=True) * (1 + rtol)) \
        & torch.isfinite(cand)
    return ((near_i.sum(-1) > 1) | (near_j.sum(-1) > 1)).numpy()


def test_cross_shard_entries_equal_reference(port_sharded, ref_sharded,
                                             queries):
    """``gather_masked_labels`` on both owners, ``covis_blocked`` on every
    participant and ``join_masked`` on the home shard agree with the
    reference's entries on a cross-shard group: ids and visibility bits
    exactly, distances at rtol 1e-6, argmin ids except at ties."""
    import jax.numpy as jnp

    s, t = queries
    sh, rsh = port_sharded[("f32", None)], ref_sharded[("f32", None)]
    eng = ShardedQueryEngine(sh, backend="torch")
    ref = RefRouter(rsh)
    key = _cross_key(eng, s, t)
    m = eng.buckets_of(s, t) == key
    st = eng.router.stage(s[m], t[m], int(key))
    i, j, W = st.i, st.j, eng.bucket_width(key)
    masked = {}
    for side, k, loc, pts in (("s", i, st.loc_s, st.s_dev),
                              ("t", j, st.loc_t, st.t_on[sh.devices[j]])):
        got = port_packed.gather_masked_labels(sh.shards[k], loc, pts, W)
        want = ref_packed.gather_masked_labels(
            rsh.shards[k], jnp.asarray(loc.numpy()),
            jnp.asarray(pts.numpy()), W)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        masked[side] = (got, want)
    for k in eng.router.covis_shards(st.s, st.t):
        bx, rbx = sh.shards[k], rsh.shards[k]
        got = port_packed.covis_blocked(st.s_dev, st.t_dev, bx.edges_a,
                                        bx.edges_b, bx.edges_c, bx.grid)
        want = ref_packed.covis_blocked(
            jnp.asarray(st.s), jnp.asarray(st.t), rbx.edges_a, rbx.edges_b,
            rbx.edges_c, rbx.grid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eng.router.fold(st)
    got = port_packed.join_masked(masked["s"][0], masked["t"][0], st.s_dev,
                                  st.t_dev, st.covis, want_argmin=True)
    want = ref_packed.join_masked(masked["s"][1], masked["t"][1],
                                  jnp.asarray(st.s), jnp.asarray(st.t),
                                  jnp.asarray(st.covis.numpy()),
                                  want_argmin=True)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert_matches_reference(got, want,
                             _ties(masked["s"][0], masked["t"][0]))
    np.testing.assert_array_equal(got[0], eng.router.join_staged(st).numpy())


def test_full_gather_entries_equal_the_bucket_query(port_bx, queries):
    """The library-only full-gather pair: ``gather_labels_at_width`` of
    both sides at a dispatch bucket's width, then ``join_gathered`` with
    the artifact's edges, equals ``query_batch_at_bucket`` bit for bit."""
    s, t = queries
    buckets = port_packed.dispatch_buckets(port_bx, s, t)
    for k in np.unique(buckets):
        m = buckets == k
        st, tt = torch.from_numpy(s[m]), torch.from_numpy(t[m])
        W = port_bx.widths[int(k)]
        labels = [port_packed.gather_labels_at_width(
            port_bx, port_packed.locate_regions(port_bx, p), W)
            for p in (st, tt)]
        got = port_packed.join_gathered(
            *labels, st, tt, port_bx.edges_a, port_bx.edges_b,
            port_bx.edges_c, port_bx.grid, want_argmin=True)
        want = port_packed.query_batch_at_bucket(port_bx, st, tt, int(k),
                                                 want_argmin=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["bf16", "f16", "bf16-i32"])
def test_quant_wire_decodes_to_the_owner_fold(layout, port_idx):
    """``dequant_masked_labels(*gather_quant_rows(...))`` equals the
    owner's own ``gather_masked_labels`` bit for bit, at every shard and
    width, on the u16 wire and on the int32 wire a bucket's id fallback
    forces (``bf16-i32``: one bucket's hub ids stored raw)."""
    lay = slab_layout(layout.split("-")[0])
    sh = ShardPlanner(N_SHARDS, layout=lay).build(port_idx, device="cpu")
    rng = np.random.default_rng(0)
    for bx in sh.shards:
        if layout.endswith("i32"):
            raw = port_packed._decode_ids(bx.hub_ids[0], bx.hub_base[0],
                                          port_packed.HUB_PAD)
            bx = dataclasses.replace(
                bx, hub_ids=(raw, *bx.hub_ids[1:]),
                hub_base=(torch.zeros_like(bx.hub_base[0]),
                          *bx.hub_base[1:]))
        id_dt, dist_dt = port_packed.wire_dtypes(bx)
        assert id_dt == (torch.int32 if layout.endswith("i32")
                         else port_packed.U16_STORAGE)
        assert dist_dt == lay.dist_dtype
        for W in sh.width_classes:
            if W < bx.widths[0]:
                continue
            B = 48
            regions = torch.from_numpy(
                rng.integers(0, bx.num_regions, B).astype(np.int32))
            pts = torch.from_numpy(rng.uniform(
                0, [bx.width, bx.height], (B, 2)).astype(np.float32))
            wire = port_packed.gather_quant_rows(bx, regions, pts, W)
            got = port_packed.dequant_masked_labels(*wire, pts, bx.vert_xy)
            want = port_packed.gather_masked_labels(bx, regions, pts, W)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_wire_dtypes_equal_reference(port_sharded, ref_sharded):
    """The wire's id and distance dtypes (u16 ids shipped as their int16
    bits in the port)."""
    to_port = {"uint16": torch.int16, "int32": torch.int32,
               "bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}
    for a, b in zip(port_sharded[("bf16", None)].shards,
                    ref_sharded[("bf16", None)].shards):
        want = ref_packed.wire_dtypes(b)
        assert port_packed.wire_dtypes(a) == tuple(to_port[np.dtype(d).name]
                                                   for d in want)


# ------------------------------------------------------ answers (port)

def test_sharded_engine_equals_single_device(port_sharded, port_bx, queries):
    """The sharded engine equals the port's single-device bucketed engine
    bit for bit (distances and all 5 argmin outputs) through ``query``,
    ``PathServer`` (padded batches) and the batcher (one-query trickles),
    in input order, with cross-shard keys present."""
    s, t = queries
    want = query_batch_bucketed(port_bx, s, t, want_argmin=True)
    eng = ShardedQueryEngine(port_sharded[("f32", None)], backend="cuda")
    _cross_key(eng, s, t)
    for a, b in zip(eng.query(s, t, want_argmin=True), want):
        np.testing.assert_array_equal(a, b)
    perm = np.random.default_rng(0).permutation(len(s))[:60]
    np.testing.assert_array_equal(eng.query(s[perm], t[perm]), want[0][perm])
    assert sum(st.gathers_out for st in eng.shard_stats()) > 0
    assert sum(st.covis_assists for st in eng.shard_stats()) > 0
    srv = PathServer(eng, batch_size=16)
    srv.warmup(paths=True)
    np.testing.assert_array_equal(srv.query(s, t), want[0])
    for a, b in zip(srv._dispatch(s[:60], t[:60], want_argmin=True), want):
        np.testing.assert_array_equal(a, b[:60])
    assert len(srv.stats.per_shard) == N_SHARDS
    tickets = [srv.submit(s[i:i + 7], t[i:i + 7], want_argmin=True)
               for i in range(0, len(s), 7)]
    srv.flush()
    assert srv.drain(timeout=120)
    got = [np.concatenate(c)
           for c in zip(*[tk.result(timeout=1) for tk in tickets])]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    srv.stop_async()
    assert all(b.occupancy <= 1.0 for b in srv.stats.per_bucket.values())
    assert sum(st.seconds for st in srv.stats.per_shard) > 0
    assert shard_imbalance(eng.shard_stats()) == eng.imbalance() <= 1.15


def test_sharded_matches_reference_single_device(port_sharded, port_bx,
                                                 ref_idx, queries):
    """Against the reference's unpadded single-device entry point: equal
    finite patterns, distances at rtol 1e-6, argmin ids equal except at the
    reference's ties."""
    s, t = queries
    want = ref_packed.query_batch_bucketed(ref_packed.pack_bucketed(ref_idx),
                                           s, t, want_argmin=True)
    want = [np.asarray(w) for w in want]
    got = ShardedQueryEngine(port_sharded[("f32", None)],
                             backend="cuda").query(s, t, want_argmin=True)
    np.testing.assert_array_equal(np.isfinite(got[0]), np.isfinite(want[0]))
    assert_matches_reference(got, want, tied_rows(port_bx, s, t))


def test_quantized_sharded_winners_equal_f32(port_sharded, port_bx, queries):
    """bf16/u16 shards: distances within 2·qerr of the f32 single-device
    engine, argmin winners equal to it bit for bit after the rescue, the
    quantized wire counted."""
    from repro_torch import obs

    s, t = queries
    want = query_batch_bucketed(port_bx, s, t, want_argmin=True)
    sh = port_sharded[("bf16", None)]
    eng = ShardedQueryEngine(sh, backend="torch")
    got = PathServer(eng, batch_size=16)._dispatch(s, t, want_argmin=True)
    qerr = max(float(bx.qerr) for bx in sh.shards)
    fin = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    assert np.all(np.abs(got[0][fin] - want[0][fin])
                  <= 2 * qerr + 64 * np.finfo(np.float32).eps
                  * np.abs(want[0][fin]))
    for name, a, b in zip(ANSWERS[1:], got[1:], want[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert eng.rescue_batches > 0
    wire = obs.REGISTRY.find("router_wire_rows_total",
                             router=eng.router._obs_labels["router"],
                             wire="quant")
    assert sum(c.value for c in wire) > 0


def test_sharded_grid_shards_equal_dense(port_sharded, port_bx, queries):
    """``edge_grid=True``: every shard attaches a grid of its clipped edges
    and the answers equal the dense single-device engine's bit for bit."""
    s, t = queries
    want = query_batch_bucketed(port_bx, s, t, want_argmin=True)
    got = ShardedQueryEngine(port_sharded[("f32", True)],
                             backend="torch").query(s, t, want_argmin=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _chambered_scene():
    """Four near-closed chambers around a center junction (>= 128 edges):
    visibility, and so label via reach, is chamber-local except through the
    doors, so per-shard clipped edge subsets really shrink."""
    from repro_torch.core.geometry import Scene

    def rect(x0, y0, x1, y1):
        return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)

    W = 120.0
    polys = [rect(58, 0, 62, 55), rect(58, 65, 62, 120),
             rect(0, 58, 55, 62), rect(65, 58, 120, 62)]
    rng = np.random.default_rng(0)
    for cx, cy in ((0, 0), (62, 0), (0, 62), (62, 62)):
        for i in range(12):
            x0 = cx + 4 + (i % 4) * 13 + rng.uniform(0, 3)
            y0 = cy + 4 + (i // 4) * 15 + rng.uniform(0, 3)
            w, h = rng.uniform(4, 7, 2)
            polys.append(rect(x0, y0, x0 + w, y0 + h))
    return Scene.build(polys, W, W)


def test_shard_edge_clipping_drops_bytes_and_stays_bitwise():
    """The reference's clip test on the port, at 12 shards: the clip keeps
    strictly fewer edges than replication on most shards, the summed edge
    bytes fall below the replicated baseline, and the clipped sharded
    engine answers bit for bit as the single-device full-edge engine."""
    scene = _chambered_scene()
    E = scene.edges.shape[0]
    assert E >= 128
    graph = build_visgraph(scene)
    idx = build_ehl(scene, 4.0, graph=graph, hl=build_hub_labels(graph))
    bx = pack_bucketed(idx, device="cpu")
    full_edge_bytes = sum(a.numel() * 4 for a in
                          (bx.edges_a, bx.edges_b, bx.edges_c)) + \
        (bx.grid.device_bytes() if bx.grid else 0)
    S = 12
    sharded = ShardPlanner(S).build(idx, device="cpu")
    kept = [int(m.sum()) for m in sharded.edge_masks]
    assert all(len(m) == E for m in sharded.edge_masks)
    assert sum(k < E for k in kept) >= S // 3, kept
    assert sum(sharded.edge_bytes()) < S * full_edge_bytes
    qs = uniform_queries(scene, graph, 60, seed=3, require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    want = query_batch_bucketed(bx, s, t, want_argmin=True)
    got = ShardedQueryEngine(sharded, backend="torch").query(
        s, t, want_argmin=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cell3_sharded_location_and_answers():
    """At cell 3.0 (not a power of two) the router's float32 host division
    sends every boundary endpoint (on and one ulp below each cell line) to
    the shard and local region where that shard's mapper locates it on the
    device, and the answers equal the oracle within 1e-4 and the
    single-device engine bit for bit."""
    idx, _, _, s, t, truth = cell3_case("cpu")
    assert check_cell3_sharded(idx, s, t, truth, "cpu") > 0


# -------------------------------------------------------------- placement

def test_entry_points_default_to_the_card(port_idx, monkeypatch):
    """Without a card every new entry point raises unless asked for the
    CPU; a mesh needs as many cards as shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    planner = ShardPlanner(N_SHARDS)
    for call in (lambda: planner.build(port_idx),
                 lambda: ShardedQueryEngine(port_idx, num_shards=N_SHARDS),
                 lambda: port_packed.pack_bucketed_split(
                     port_idx, planner.plan(port_idx).assignment),
                 lambda: shard_devices(None, N_SHARDS)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(ValueError, match="CUDA devices"):
        make_serving_mesh(N_SHARDS)
    assert shard_devices(None, 3, device="cpu") == [torch.device("cpu")] * 3
    assert shard_devices(("cpu", "cpu"), 2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="devices for"):
        shard_devices(("cpu",), 2)
    eng = ShardedQueryEngine(port_idx, num_shards=2, backend="torch",
                             device="cpu")
    assert [str(d) for d in eng.index.devices] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="devices for"):
        ShardedQueryEngine(eng.index, mesh=("cpu",))


# ------------------------------------------------------------- manager

def _managers(scene_s, graph_s, hl_s, port_s, **kw):
    """The reference's sharded manager and the port's on the same
    uncompressed rooms-S index, budget (0.5x bucketed + overhead), seed
    and settings."""
    ref_idx = ref_build_ehl(scene_s, 2.0, graph=graph_s, hl=hl_s)
    budget = int(ref_packed.bucketed_device_bytes(ref_idx) * 0.5) \
        + ref_overhead(ref_idx, N_SHARDS)
    kw = dict(dict(batch_size=32, min_queries=60, replan_threshold=0.10,
                   min_dwell=0, probe_n=16, num_shards=N_SHARDS, seed=13),
              **kw)
    ref = RefManager(ref_idx, budget, backend="jnp", **kw)
    scene, graph, hl = port_s
    port = IndexManager(build_ehl(scene, 2.0, graph=graph, hl=hl), budget,
                        backend="torch", device="cpu", **kw)
    return ref, port, budget


def test_sharded_manager_equals_reference(scene_s, graph_s, hl_s, port_s):
    """``IndexManager(num_shards=4)`` takes the reference's decision on the
    same traffic and produces its regions, per-shard bytes and regions,
    mapper and lifecycle stats; probe answers agree at rtol 1e-6; the swap
    replaces every shard under one generation."""
    ref, port, budget = _managers(scene_s, graph_s, hl_s, port_s)
    assert port.device_budget_bytes() == ref.device_budget_bytes() == budget
    assert port.engine.per_shard_bytes() == ref.engine.per_shard_bytes()
    old = port.engine.artifact
    qs = ref_cluster_queries(scene_s, graph_s, 2, 150, seed=31,
                             require_path=False)
    for m in (ref, port):
        m.recorder.record(qs.s, qs.t)
    assert port.planner.drift(port.recorder) == pytest.approx(
        ref.planner.drift(ref.recorder), abs=1e-12)
    assert port.maybe_adapt() is ref.maybe_adapt() is True
    p, r = port.history[-1], ref.history[-1]
    assert (p.kind, p.regions, p.merges, p.label_bytes, p.device_bytes) == \
        (r.kind, r.regions, r.merges, r.label_bytes, r.device_bytes)
    np.testing.assert_array_equal(np.asarray(port.host_index.mapper),
                                  np.asarray(ref.host_index.mapper))
    assert port.engine.per_shard_bytes() == ref.engine.per_shard_bytes()
    assert [bx.num_regions for bx in port.engine.artifact.shards] == \
        [bx.num_regions for bx in ref.engine.current.index.shards]
    ps, rs = port.stats(), ref.stats()
    for k in ("generation", "swaps", "device_bytes", "device_budget_bytes",
              "num_shards", "per_shard_bytes", "shard_imbalance"):
        assert ps[k] == rs[k], k
    new = port.engine.artifact
    assert not any(a is b for a, b in zip(new.shards, old.shards))
    dp, dr = port.probe_answers(), ref.probe_answers()
    np.testing.assert_array_equal(np.isfinite(dp), np.isfinite(dr))
    fin = np.isfinite(dr)
    np.testing.assert_allclose(dp[fin], dr[fin], rtol=1e-6)
    assert max(port.engine.per_shard_bytes()) <= 1.15 * budget / N_SHARDS


def _port_manager(port_s, **kw):
    scene, graph, hl = port_s
    idx = build_ehl(scene, 2.0, graph=graph, hl=hl)
    budget = int(bucketed_device_bytes(idx) * 0.5) \
        + sharded_overhead_bytes(idx, N_SHARDS)
    kw = dict(dict(batch_size=16, min_queries=40, replan_threshold=0.10,
                   min_dwell=0, probe_n=8, num_shards=N_SHARDS, seed=5),
              **kw)
    return IndexManager(idx, budget, backend="torch", device="cpu", **kw)


def test_pinned_request_never_mixes_generations(port_s, monkeypatch):
    """Every engine call of one PathServer request hits one shard set even
    when a swap lands mid-request; a pinned request keeps the old shard
    set alive until it drains."""
    scene, graph, _ = port_s
    mgr = _port_manager(port_s)
    srv = PathServer(mgr.engine, batch_size=16, recorder=mgr.recorder)
    served_by: list = []
    orig = ShardedQueryEngine.batch

    def spy(self, s, t, bucket=0):
        served_by.append(id(self))
        if len(served_by) == 2:
            qs = cluster_queries(scene, graph, 2, 80, seed=61,
                                 require_path=False)
            mgr.recorder.record(qs.s, qs.t)
            assert mgr.maybe_adapt() is True
        return orig(self, s, t, bucket=bucket)

    monkeypatch.setattr(ShardedQueryEngine, "batch", spy)
    qs = uniform_queries(scene, graph, 120, seed=7, require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    d_old = srv.query(s, t)
    assert len(served_by) >= 3 and len(set(served_by)) == 1
    assert mgr.generation == 1 and srv.stats.stale_batches > 0
    monkeypatch.setattr(ShardedQueryEngine, "batch", orig)

    old_engine = mgr.engine.current
    cm = mgr.engine.pin()
    pinned = cm.__enter__()
    assert pinned is old_engine
    mgr.recorder.record(*(q.astype(np.float32) for q in (
        cluster_queries(scene, graph, 2, 200, seed=3,
                        require_path=False).s,
        cluster_queries(scene, graph, 2, 200, seed=3,
                        require_path=False).t)))
    assert mgr.maybe_adapt() is True
    assert mgr.engine.retired_generations() == [1]
    np.testing.assert_array_equal(pinned.query(s, t), mgr.engine.query(s, t))
    np.testing.assert_array_equal(pinned.query(s, t), d_old)
    cm.__exit__(None, None, None)
    assert mgr.engine.retired_generations() == []
    assert mgr.engine.drops == mgr.engine.swaps == 2


def test_per_shard_cap_aborts_the_candidate(port_s):
    """A candidate whose largest shard exceeds ``shard_tol`` times its fair
    share of the budget is aborted (the live shards stay), loudly."""
    scene, graph, _ = port_s
    mgr = _port_manager(port_s, shard_tol=0.5)
    qs = cluster_queries(scene, graph, 2, 150, seed=31, require_path=False)
    mgr.recorder.record(qs.s, qs.t)
    live = mgr.engine.current
    assert mgr.maybe_adapt() is False
    assert mgr.generation == 0 and mgr.engine.current is live
    assert mgr.validation_failures == 1
    rec = mgr.history[-1]
    assert not rec.swapped and "shard imbalance" in rec.abort_reason
    (ev,) = mgr.telemetry.events.events("swap_abort")
    assert "per-device cap" in ev["abort_reason"]


# ------------------------------------------------------------- example

def test_example_shards_on_the_cpu():
    """``examples/pathfind_serve_torch.py --shards 4`` on the CPU: exits 0
    (its gates: answers equal the single-device engine bit for bit, every
    shard within its per-device cap) and prints the per-shard lines."""
    out = subprocess.run(
        [sys.executable, str(EXAMPLE), "--device", "cpu", "--map", "rooms-S",
         "--queries", "48", "--batch", "16", "--budget", "0.3",
         "--shards", "4", "--paths", "8", "--serve-async"],
        capture_output=True, text=True, timeout=300,
        env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin",
             "HOME": str(pathlib.Path.home())})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "shard 3:" in out.stdout and "bitwise-identical" in out.stdout
