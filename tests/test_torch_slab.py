"""Port single slab, point location at cell 3.0 and the warmup check (CPU).

``pack_index`` must produce the reference's planes (2-byte planes compared
as their uint16 bits), bytes and slot counts under f32, bf16/u16 and
f16/u16, with and without an edge grid.  Slab answers: within rtol 1e-6 of
the reference's slab entry points, argmin ids equal except at the
reference's ties; within the port equal to the bucketed layout's bit for
bit; a quantized slab's rescued winners equal the f32 slab's.  At cell 3.0
the port locates every boundary point where its host mirrors do; the
reference's jitted location differs on the rows named below, where the port
matches the float64 oracle.  After ``warmup(paths=True)`` live traffic
meets no cold shape key (``core.packed.TRACES``).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import packed as ref_packed
from repro.core.compression import compress_to_fraction as ref_compress
from repro.core.grid import build_ehl as ref_build_ehl
from repro_torch import obs
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.visgraph import build_visgraph
from repro_torch.kernels import ref as port_ref
from repro_torch.serving import (CudaEngine, PathServer, TorchEngine,
                                 make_engine)

from test_torch_cuda import cell3_case, check_cell3
from test_torch_packed import grid_planes
from test_torch_quantized import bits

HOST_TOL = 1e-4
SLAB_PLANES = ("hub_ids", "via_xy", "via_d", "via_ids", "mapper",
               "edges_a", "edges_b", "edges_c", "vert_xy", "hub_base",
               "vid_base")
SLAB_STATIC = ("nx", "ny", "cell_size", "width", "height")
# cell 3.0 queries (``cell3_case`` order) the reference serves from a region
# its jitted location picked one cell too far (ROADMAP queue 3, item 2):
# s or t = (26.999998, 30), served +inf where the oracle gives 23.0113
REF_JIT_LOCATION_ROWS = [27, 103]


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
def port_index():
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def queries(queries_s):
    return queries_s.s.astype(np.float32), queries_s.t.astype(np.float32)


def _pack(idx, layout: str, device="cpu", **kw):
    return port_packed.pack_index(idx, layout=port_packed.slab_layout(layout),
                                  device=device, **kw)


# ---------------------------------------------------------------------------
# planes, bytes, slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,edge_grid,pad", [
    ("f32", None, 1), ("bf16", None, 1), ("f16", None, 1), ("f32", True, 8),
    ("bf16", True, 8)])
def test_slab_planes_and_bytes_match_reference(port_index, compressed_s,
                                               layout, edge_grid, pad):
    kw = dict(edge_grid=edge_grid, region_pad_multiple=pad)
    ref = ref_packed.pack_index(
        compressed_s[0], layout=ref_packed.slab_layout(layout), **kw)
    got = _pack(port_index, layout, **kw)
    for k in SLAB_PLANES:
        want, have = getattr(ref, k), getattr(got, k)
        assert (want is None) == (have is None), k
        if want is not None:
            np.testing.assert_array_equal(bits(have), bits(want), err_msg=k)
    for k in SLAB_STATIC:
        assert getattr(got, k) == getattr(ref, k), k
    assert got.layout.dist == ref.layout.dist
    assert got.layout.ids == ref.layout.ids
    want_grid, have_grid = grid_planes(ref.grid), grid_planes(got.grid)
    assert (want_grid is None) == (have_grid is None)
    assert (have_grid is not None) == bool(edge_grid)
    for k in want_grid or ():
        np.testing.assert_array_equal(have_grid[k], want_grid[k], err_msg=k)
    port_lay = port_packed.slab_layout(layout)
    est = port_packed.slab_device_bytes(port_index, layout=port_lay, **kw)
    assert got.device_bytes() == ref.device_bytes() == est == \
        ref_packed.slab_device_bytes(compressed_s[0],
                                     layout=ref_packed.slab_layout(layout),
                                     **kw)
    assert got.label_slots() == ref.label_slots() == \
        port_packed.slab_label_slots(port_index, region_pad_multiple=pad)
    if layout != "f32":
        qs, rs = got.quant_stats(), ref.quant_stats()
        assert qs["qerr"] == rs["qerr"]
        for k in ("id_fallback", "vid_fallback", "dist_fallback"):
            assert qs[k] == rs[k], k
        assert got.residual.widths == (got.label_width,)
        np.testing.assert_array_equal(got.residual.d[0], ref.residual.d[0])


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_slab_hub_rows_sorted_with_pads_at_the_tail(port_index, layout):
    """The join kernel's fast path needs sorted hub rows: decoded hub ids
    ascend along each row and ``HUB_PAD`` fills only its tail."""
    pk = _pack(port_index, layout)
    hub = port_packed._gather_packed(
        pk, torch.arange(pk.num_regions))[0].numpy()
    assert np.all(np.diff(hub.astype(np.int64), axis=1) >= 0)
    pad = hub == port_packed.HUB_PAD
    assert np.all(pad[:, 1:] >= pad[:, :-1])          # pads form a suffix
    used, _ = pk.label_slots()
    assert int((~pad).sum()) == used


# ---------------------------------------------------------------------------
# answers
# ---------------------------------------------------------------------------

def slab_tied_rows(pk, s, t, rtol=1e-6) -> np.ndarray:
    """[N] bool — rows whose slab join has a second candidate within
    ``rtol`` of the winner (over i, or over j at the winning hub)."""
    st, tt = torch.from_numpy(s), torch.from_numpy(t)
    hs, vs, _ = port_packed._fold_endpoint(pk, st)
    ht, vt, _ = port_packed._fold_endpoint(pk, tt)
    rowmin = port_ref.label_join_rowmin_ref(hs, vs, ht, vt)
    best = rowmin.amin(-1, keepdim=True)
    near_i = (rowmin <= best * (1 + rtol)) & torch.isfinite(rowmin)
    hub_i = torch.gather(hs, 1, rowmin.argmin(-1, keepdim=True))
    cand = torch.where(ht == hub_i, vt, torch.tensor(float("inf")))
    best_j = cand.amin(-1, keepdim=True)
    near_j = (cand <= best_j * (1 + rtol)) & torch.isfinite(cand)
    return ((near_i.sum(-1) > 1) | (near_j.sum(-1) > 1)).numpy()


@pytest.fixture(scope="module")
def answers(port_index, queries):
    """{layout: (slab 5-tuple, bucketed 5-tuple, slab artifact)}: argmin
    answers on ``queries_s``, both unpadded (quantized rows rescued)."""
    out = {}
    for layout in ("f32", "bf16"):
        lay = port_packed.slab_layout(layout)
        pk = port_packed.pack_index(port_index, layout=lay, device="cpu")
        bx = port_packed.pack_bucketed(port_index, layout=lay, device="cpu")
        slab = TorchEngine(pk).batch_argmin(*queries)
        bucketed = port_packed.query_batch_bucketed(bx, *queries,
                                                    want_argmin=True)
        out[layout] = (slab, bucketed, pk)
    return out


def test_slab_answers_match_reference_and_oracle(answers, compressed_s,
                                                 queries):
    slab, _, pk = answers["f32"]
    ref = ref_packed.pack_index(compressed_s[0])
    want = [np.asarray(a) for a in
            ref_packed.query_batch_argmin(ref, *queries)]
    d, covis, via_s, hub, via_t = slab
    assert [a.dtype for a in slab] == [a.dtype for a in want]
    np.testing.assert_allclose(d, want[0], rtol=1e-6)
    np.testing.assert_array_equal(covis, want[1])
    differ = (via_s != want[2]) | (hub != want[3]) | (via_t != want[4])
    tied = slab_tied_rows(pk, *queries)
    assert not (differ & ~tied).any(), np.nonzero(differ & ~tied)
    np.testing.assert_array_equal(
        port_packed.query_batch(pk, *queries).numpy(), d)
    truth = compressed_s[1]
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(truth))
    fin = np.isfinite(truth)
    np.testing.assert_allclose(d[fin], truth[fin], rtol=HOST_TOL,
                               atol=HOST_TOL)


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_slab_equals_bucketed_bitwise(answers, layout):
    slab, bucketed, _ = answers[layout]
    for a, b in zip(slab, bucketed):
        np.testing.assert_array_equal(a, b)


def test_quantized_slab_winners_equal_f32_slab(answers):
    f32, _, _ = answers["f32"]
    q, _, qpk = answers["bf16"]
    for a, b in zip(q[1:], f32[1:]):
        np.testing.assert_array_equal(a, b)
    fin = np.isfinite(f32[0])
    np.testing.assert_array_equal(np.isfinite(q[0]), fin)
    assert np.all(np.abs(q[0][fin] - f32[0][fin])
                  <= 2 * float(qpk.qerr) + 1e-6 * np.abs(f32[0][fin]))


def test_engines_and_server_take_the_slab(port_index, queries):
    """``make_engine``/``PathServer`` serve a ``PackedIndex`` as one bucket
    of its label width; a static engine pins itself at generation 0."""
    pk = _pack(port_index, "f32")
    eng = make_engine(pk, backend="torch")
    assert isinstance(eng, TorchEngine)
    assert eng.num_buckets == 1 and eng.bucket_width(0) == pk.label_width
    np.testing.assert_array_equal(eng.buckets_of(*queries),
                                  np.zeros(len(queries[0]), np.int32))
    assert eng.device_bytes() == pk.device_bytes()
    with eng.pin() as pinned:
        assert pinned is eng and pinned.generation == 0
    srv = PathServer(pk, backend="cuda", device="cpu", batch_size=16)
    assert isinstance(srv.engine, CudaEngine)
    d = srv.query(queries[0][:5], queries[1][:5])
    np.testing.assert_array_equal(
        d, port_packed.query_batch(pk, queries[0][:5], queries[1][:5]))
    assert srv.stats.per_bucket[0].width == pk.label_width


# ---------------------------------------------------------------------------
# cell 3.0: location on the CPU, and the reference's rows
# ---------------------------------------------------------------------------

def test_cell3_location_and_reference_rows(scene_s, graph_s, hl_s):
    """The port locates every cell-3.0 boundary point where its host
    mirrors do and serves every reachable query within 1e-4 of the oracle;
    the host helper ``locate_cells`` finds the cells ``locate_regions``
    gathers, on the bucketed layout and the single slab; its distances
    equal the reference's (rtol 1e-6) except on ``REF_JIT_LOCATION_ROWS``,
    where the reference serves +inf."""
    idx, bx, eng, s, t, truth = case = cell3_case("cpu")
    assert check_cell3(*case) > 0
    pts = np.concatenate([s, t])
    for art in (bx, port_packed.pack_index(idx, device="cpu")):
        cells = port_packed.locate_cells(pts, art.cell_size, art.nx, art.ny)
        np.testing.assert_array_equal(
            art.mapper.numpy()[cells],
            port_packed.locate_regions(art, torch.from_numpy(pts)).numpy())
    ridx = ref_build_ehl(scene_s, cell_size=3.0, graph=graph_s, hl=hl_s)
    ref_compress(ridx, 0.2)
    rbx = ref_packed.pack_bucketed(ridx)
    want = np.asarray(ref_packed.query_batch_bucketed(rbx, s, t))
    got = port_packed.query_batch_bucketed(bx, s, t)
    rows = np.zeros(len(s), bool)
    rows[REF_JIT_LOCATION_ROWS] = True
    np.testing.assert_allclose(got[~rows], want[~rows], rtol=1e-6)
    assert np.all(np.isinf(want[rows]))
    np.testing.assert_allclose(got[rows], truth[rows], rtol=HOST_TOL)


# ---------------------------------------------------------------------------
# the warmup check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16", "f32-slab"])
def test_warmup_leaves_nothing_cold(port_index, queries, kind):
    """After ``warmup(paths=True)`` live traffic (every bucket, a ragged
    tail, ``query_paths``, the async path and, on bf16, the rescue) meets
    no shape key that warmup did not; the counter is live: an unseen batch
    size bumps it."""
    layout, _, packer = kind.partition("-")
    lay = port_packed.slab_layout(layout)
    pack = port_packed.pack_index if packer else port_packed.pack_bucketed
    eng = CudaEngine(pack(port_index, layout=lay, device="cpu"))
    srv = PathServer(eng, batch_size=16)
    srv.warmup(paths=True)
    c0 = port_packed.TRACES.count
    assert {"fold_endpoint", "join_endpoints"} <= {
        dict(m.labels)["entry"] for m in obs.REGISTRY.series(
            "entry_cold_total") if m.value > 0}
    rescued0 = obs.REGISTRY.total("rescue_batches_total", engine=eng.name)
    s, t = queries
    srv.query(s, t)                                  # every bucket present
    srv.query(s[:7], t[:7])                          # ragged tail (padded)
    srv.query_paths(s[:5], t[:5], host_index=port_index)
    tk = srv.submit(s[:9], t[:9], want_argmin=True)
    srv.flush()
    tk.result(timeout=60)
    srv.stop_async()
    if layout != "f32":
        assert obs.REGISTRY.total("rescue_batches_total",
                                  engine=eng.name) > rescued0
    assert port_packed.TRACES.count == c0, \
        "serving traffic hit a shape warmup did not"
    PathServer(eng, batch_size=13).query(s[:3], t[:3])
    assert port_packed.TRACES.count > c0
