"""Hopper kernels vs their plain twins on the card (``pytest -m cuda``).

Each test asks the ``card`` fixture for the device, and the fixture skips
when no CUDA device is present, so every worker collects the same tests.
The kernels must equal their twins bit for bit (``torch.equal``).  Also on
the card: point location at a cell size that is not a power of two, the
single-slab engines, the split-phase (async) path against the synchronous
one, and the warmup check (no build, load or cold shape on live traffic);
and the LM port's reduced families (card forward == CPU forward, decode ==
forward, ``LMServer`` tokens card == CPU).
This module imports no JAX (the card's machine has none); names added with
the slab and async slice are imported inside the tests that use them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.packed import pack_bucketed
from repro_torch.core.visgraph import build_visgraph
from repro_torch.core.workload import uniform_queries
from repro_torch.kernels import ref
from repro_torch.core.packed import HUB_PAD
from repro_torch.kernels.label_join import label_join_rowmin
from repro_torch.kernels.segvis import _launch as segvis_launch
from repro_torch.kernels.segvis import segvis
from repro_torch.kernels.segvis_tiles import segvis_tiles
from repro_torch.obs import REGISTRY

pytestmark = pytest.mark.cuda


def cold_counts() -> tuple:
    """(cold shape keys, nvcc builds, ctypes loads) so far in this
    process; the builds and loads from the registry's series."""
    from repro_torch.core.packed import TRACES

    return (TRACES.count, REGISTRY.total("kernel_builds_total"),
            REGISTRY.total("kernel_loads_total"))


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m cuda` on the card)")
    return torch.device("cuda", 0)


def _segs(rng, n, e, card):
    arrs = [rng.uniform(0, 10, (k, 2)).astype(np.float32)
            for k in (n, n, e, e, e)]
    # anchor some segments on edge endpoints: the exact-contact classes
    m = min(n, e)
    arrs[1][:m // 2] = arrs[2][:m // 2]
    return [torch.from_numpy(a).to(card) for a in arrs]


@pytest.mark.parametrize("n,e", [(1, 1), (7, 64), (256, 128), (300, 700),
                                 (32768, 128)])
def test_segvis_kernel_equals_twin(card, n, e):
    args = _segs(np.random.default_rng(n + e), n, e, card)
    got = segvis(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.segvis_ref(*args))


def _contact_segs(rng, n, e, card):
    """Random segments with every exact-contact class: ends on an edge
    vertex, starts on one, degenerate segments and edges, ends on an open
    edge, and collinear slides along an edge's line."""
    p, q, a, b, c = (rng.uniform(0, 10, (k, 2)).astype(np.float32)
                     for k in (n, n, e, e, e))
    m = min(n, e)
    q[:m // 3] = a[:m // 3]
    p[m // 3:m // 2] = b[m // 3:m // 2]
    q[m // 2:2 * m // 3] = p[m // 2:2 * m // 3]
    b[:e // 4] = a[:e // 4]
    mid = (a[e // 4:e // 2] + b[e // 4:e // 2]) / 2
    k = min(len(mid), n - 2 * m // 3)
    q[2 * m // 3:2 * m // 3 + k] = mid[:k]
    lo = 2 * m // 3 + k
    j = min(n - lo, e)
    p[lo:lo + j] = 2 * a[:j] - b[:j]               # a - (b - a): on the line
    q[lo:lo + j] = a[:j] + (b[:j] - a[:j]) / 4
    return [torch.from_numpy(x).to(card) for x in (p, q, a, b, c)]


@pytest.mark.parametrize("n", [1, 7, 256, 300, 1000, 2000, 4096, 6000, 12000,
                               32768, 65536, 131072,
                               200000, 300000])
@pytest.mark.parametrize("e", [1, 64, 128, 700])
def test_segvis_kernel_equals_twin_at_every_group(card, n, e):
    """Every group size the wrapper picks (N = 1 .. 300000), E = 1, E not a
    multiple of 32, E over one shared tile of 256 edges, with contacts."""
    args = _contact_segs(np.random.default_rng(n * 13 + e), n, e, card)
    got = segvis(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == (n,)
    assert torch.equal(got, ref.segvis_ref(*args))


@pytest.mark.parametrize("group", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("threads", [32, 256])
@pytest.mark.parametrize("e", [128, 700])
def test_segvis_explicit_launch_shapes_equal_twin(card, group, threads, e):
    """Every G, one warp or 256 threads a block, one edge tile or three."""
    n = 1000
    args = _contact_segs(np.random.default_rng(group + threads + e), n, e,
                         card)
    out = torch.empty(n, dtype=torch.bool, device=card)
    segvis_launch(*args, out, group, threads)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.segvis_ref(*args))


def test_segvis_launch_refuses_bad_shapes(card):
    args = _contact_segs(np.random.default_rng(0), 8, 8, card)
    out = torch.empty(8, dtype=torch.bool, device=card)
    for group, threads in ((3, 32), (64, 64), (1, 48), (32, 512)):
        with pytest.raises(RuntimeError, match="cudaError"):
            segvis_launch(*args, out, group, threads)


@pytest.mark.parametrize("b,l", [(1, 16), (33, 384), (256, 512), (3, 1500)])
def test_rowmin_kernel_equals_twin(card, b, l):
    rng = np.random.default_rng(b * 7919 + l)
    hs = np.sort(rng.integers(0, 64, (b, l)).astype(np.int32), axis=1)
    ht = np.sort(rng.integers(0, 64, (b, l)).astype(np.int32), axis=1)
    vs = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vt = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vs[rng.random((b, l)) < 0.2] = np.inf
    vt[rng.random((b, l)) < 0.2] = np.inf
    args = [torch.from_numpy(a).to(card) for a in (hs, vs, ht, vt)]
    got = label_join_rowmin(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.label_join_rowmin_ref(*args))


def _join_rows(rng, b, l, hubs, sort=True, inf_share=0.2):
    hs = rng.integers(0, hubs, (b, l)).astype(np.int32)
    ht = rng.integers(0, hubs, (b, l)).astype(np.int32)
    if sort:
        hs.sort(axis=1)
        ht.sort(axis=1)
    vs = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vt = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vs[rng.random((b, l)) < inf_share] = np.inf
    vt[rng.random((b, l)) < inf_share] = np.inf
    return hs, vs, ht, vt


def _join_case(case):
    rng = np.random.default_rng(len(case))
    if case == "unsorted":
        return _join_rows(rng, 17, 512, 40, sort=False)
    if case == "partly_sorted":             # sorted rows, a few swapped pairs
        hs, vs, ht, vt = _join_rows(rng, 9, 700, 60)
        ht[::2, [10, 400]] = ht[::2, [400, 10]]
        return hs, vs, ht, vt
    if case == "all_equal":
        return _join_rows(rng, 8, 512, 1)
    if case == "no_common_hub":
        hs, vs, ht, vt = _join_rows(rng, 8, 256, 50)
        return hs, vs, ht + 50, vt
    if case == "all_inf":
        return _join_rows(rng, 8, 256, 20, inf_share=1.0)
    if case == "padded_tail":               # the main path's HUB_PAD tails
        hs, vs, ht, vt = _join_rows(rng, 16, 512, 96)
        for h, v in ((hs, vs), (ht, vt)):
            for r in range(len(h)):
                k = rng.integers(0, 513)
                h[r, k:] = HUB_PAD
                v[r, k:] = np.inf
        return hs, vs, ht, vt
    if case == "over_tile":                 # 16384-label chunks: 2 per row
        hs, vs, ht, vt = _join_rows(rng, 3, 20000, 300)
        ht[1, 18000:] = ht[1, 18000:][::-1].copy()   # second chunk unsorted
        ht[2, :5] = ht[2, 4::-1].copy()             # first chunk unsorted
        return hs, vs, ht, vt
    raise ValueError(case)


@pytest.mark.parametrize("case", ["unsorted", "partly_sorted", "all_equal",
                                  "no_common_hub", "all_inf", "padded_tail",
                                  "over_tile"])
def test_rowmin_kernel_equals_twin_on_any_row(card, case):
    """Sorted or not, all-equal hubs, no match, all +inf, HUB_PAD tails, and
    rows wider than one shared-memory chunk."""
    args = [torch.from_numpy(a).to(card) for a in _join_case(case)]
    got = label_join_rowmin(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.label_join_rowmin_ref(*args))


NARROW = {"bf16": torch.bfloat16, "f16": torch.float16}


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
@pytest.mark.parametrize("case", ["sorted_128", "sorted_512", "unsorted",
                                  "padded_tail", "over_tile"])
def test_rowmin_kernel_narrow_distances_equal_twin(card, dtype, case):
    """bf16/f16 distances, widened at staging: float32 output equal to the
    twin's, on sorted main-path widths and on rows that take the kernel's
    dense chunk (unsorted) or span two chunks."""
    if case.startswith("sorted"):
        rows = _join_rows(np.random.default_rng(len(case)), 256,
                          int(case.split("_")[1]), 96)
    else:
        rows = _join_case(case)
    hs, vs, ht, vt = [torch.from_numpy(a).to(card) for a in rows]
    vs, vt = vs.to(NARROW[dtype]), vt.to(NARROW[dtype])
    got = label_join_rowmin(hs, vs, ht, vt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.label_join_rowmin_ref(hs, vs, ht, vt))


def test_rowmin_wrapper_refuses_mixed_or_integer_distances(card):
    h = torch.zeros((2, 8), dtype=torch.int32, device=card)
    v = torch.zeros((2, 8), device=card)
    with pytest.raises(TypeError):
        label_join_rowmin(h, v.bfloat16(), h, v.half())
    with pytest.raises(TypeError):
        label_join_rowmin(h, v.bfloat16(), h, v)
    with pytest.raises(TypeError):
        label_join_rowmin(h, v.int(), h, v.int())


def test_wrappers_check_their_inputs(card):
    x = torch.zeros((4, 2), device=card)
    with pytest.raises(TypeError):
        segvis(x.double(), x, x, x)
    with pytest.raises(ValueError):
        segvis(x, x, x[:, :1].contiguous(), x)
    h = torch.zeros((2, 8), dtype=torch.int32, device=card)
    v = torch.zeros((2, 8), device=card)
    with pytest.raises(TypeError):
        label_join_rowmin(h, v.half(), h, v)
    with pytest.raises(ValueError):
        label_join_rowmin(h, v, h, v.t())


def _tiles(rng, n, s, card):
    """Endpoints and six [N, S] planes: zero-padded slots, degenerate edges,
    segments ending on slot vertices."""
    p = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    q = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    a, b, c = (rng.uniform(0, 10, (n, s, 2)).astype(np.float32)
               for _ in range(3))
    pad = rng.random((n, s)) < 0.25
    a[pad] = b[pad] = c[pad] = 0.0
    degen = rng.random((n, s)) < 0.1
    b[degen] = a[degen]
    if s:
        k = rng.integers(0, s, n)
        anchor = rng.random(n) < 0.4
        q[anchor] = a[np.arange(n), k][anchor]
    planes = [np.ascontiguousarray(x[..., i]) for x in (a, b, c)
              for i in (0, 1)]
    return [torch.from_numpy(x).to(card) for x in [p, q] + planes]


@pytest.mark.parametrize("n,s", [(1, 1), (7, 33), (300, 600), (256, 96),
                                 (1000, 1), (8192, 192), (5, 0)])
def test_segvis_tiles_kernel_equals_twin(card, n, s):
    args = _tiles(np.random.default_rng(n * 31 + s), n, s, card)
    got = segvis_tiles(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.segvis_tiles_ref(*args))


def test_segvis_tiles_wrapper_checks_inputs(card):
    p = torch.zeros((4, 2), device=card)
    t = torch.zeros((4, 8), device=card)
    with pytest.raises(TypeError):
        segvis_tiles(p, p, t.double(), t, t, t, t, t)
    with pytest.raises(ValueError):
        segvis_tiles(p, p, t, t[:, :7].contiguous(), t, t, t, t)
    with pytest.raises(ValueError):
        segvis_tiles(p, p[:3], t, t, t, t, t, t)
    with pytest.raises(ValueError):
        segvis_tiles(p, p, t, t, t, t, t, t.t().contiguous().t())
    with pytest.raises(ValueError, match="CUDA"):
        segvis_tiles(p.cpu(), p.cpu(), *[t.cpu()] * 6)


def test_cuda_engine_on_grid_equals_torch_and_dense(card):
    """Forced-grid artifact: CudaEngine == TorchEngine == dense CudaEngine,
    and the grid serving launches segvis_tiles, never dense segvis."""
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    grid_bx = pack_bucketed(idx, edge_grid=True, device=card)
    dense_bx = pack_bucketed(idx, edge_grid=False, device=card)
    qs = uniform_queries(scene, graph, 300, seed=5)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    dense_launches, tile_launches = segvis.launches, segvis_tiles.launches
    a = PathServer(CudaEngine(grid_bx), batch_size=64)._dispatch(s, t, True)
    assert segvis_tiles.launches > tile_launches
    assert segvis.launches == dense_launches
    b = PathServer(TorchEngine(grid_bx), batch_size=64)._dispatch(s, t, True)
    c = PathServer(CudaEngine(dense_bx), batch_size=64)._dispatch(s, t, True)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def test_cuda_engine_equals_torch_engine_on_card(card):
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    bx = pack_bucketed(idx, device=card)
    qs = uniform_queries(scene, graph, 300, seed=5)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    launches = segvis.launches
    a = PathServer(CudaEngine(bx), batch_size=64)._dispatch(s, t, True)
    assert segvis.launches > launches
    b = PathServer(TorchEngine(bx), batch_size=64)._dispatch(s, t, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layout", ["bf16", "f16"])
def test_quantized_cuda_engine_equals_torch_engine(card, layout):
    """rooms-S quantized slabs on the card: CudaEngine == TorchEngine on all
    five outputs after the rescue, the winners equal the f32 CudaEngine's,
    and serving launches both kernels."""
    from repro_torch.core.packed import slab_layout
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qbx = pack_bucketed(idx, layout=slab_layout(layout), device=card)
    bx = pack_bucketed(idx, device=card)
    qs = uniform_queries(scene, graph, 300, seed=5)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    seg, join = segvis.launches, label_join_rowmin.launches
    eng = CudaEngine(qbx)
    rescued0 = REGISTRY.total("rescue_batches_total", engine=eng.name)
    a = PathServer(eng, batch_size=64)._dispatch(s, t, True)
    assert segvis.launches > seg and label_join_rowmin.launches > join
    assert REGISTRY.total("rescue_batches_total", engine=eng.name) > rescued0
    b = PathServer(TorchEngine(qbx), batch_size=64)._dispatch(s, t, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = PathServer(CudaEngine(bx), batch_size=64)._dispatch(s, t, True)
    for x, y in zip(a[1:], c[1:]):
        np.testing.assert_array_equal(x, y)
    fin = np.isfinite(c[0])
    assert np.array_equal(fin, np.isfinite(a[0]))
    assert np.all(np.abs(a[0][fin] - c[0][fin])
                  <= 2 * float(qbx.qerr) + 1e-6 * np.abs(c[0][fin]))


# ---------------------------------------------------------------------------
# point location at cell 3.0 (the card's division must be the host's)
# ---------------------------------------------------------------------------

CELL3 = 3.0


def cell3_case(device):
    """rooms-S seed 1 at budget 0.2 and cell 3.0, with queries whose one
    endpoint lies on a cell boundary line (x = 3k at y = 30, y = 3k at
    x = 30) or one float32 ulp below it, and whose other endpoint is a free
    point of the narrowest bucket, both ways round.  Located one cell too
    far, a boundary point lands in a region the host routing did not pick;
    where that region lies in a wider bucket the query is served pure
    padding.  Returns (index, bx, engine, s, t, float64 truth)."""
    from repro_torch.core.query import query as host_query
    from repro_torch.serving import CudaEngine

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=CELL3, graph=graph)
    compress_to_fraction(idx, 0.2)
    bx = pack_bucketed(idx, device=device)
    eng = CudaEngine(bx)
    lines = np.float32(CELL3 * np.arange(1, idx.nx))
    vals = np.concatenate([lines, np.nextafter(lines, np.float32(-np.inf))])
    mid = np.full_like(vals, 30.0)
    edge = np.concatenate([np.stack([vals, mid], 1),
                           np.stack([mid, vals], 1)]).astype(np.float32)
    free = uniform_queries(scene, graph, 400, seed=7).t.astype(np.float32)
    free = free[eng._route(free) == 0][:len(edge)]
    assert len(free) == len(edge)
    s = np.concatenate([edge, free])
    t = np.concatenate([free, edge])
    truth = np.array([host_query(idx, a, b, want_path=False)[0]
                      for a, b in zip(s, t)])
    return idx, bx, eng, s, t, truth


def check_cell3(idx, bx, eng, s, t, truth):
    """Device location == the host mirrors on every endpoint, and every
    query the oracle reaches served within 1e-4 of it."""
    from repro_torch.core.packed import locate_regions, slab_layout
    from repro_torch.serving import PathServer

    pts = np.concatenate([s, t])
    got = locate_regions(bx, torch.from_numpy(pts).to(bx.device))
    got = got.cpu().numpy()
    qbx = pack_bucketed(idx, layout=slab_layout("bf16"), device="cpu")
    want = qbx.residual.locate(pts)
    bad = np.nonzero(got != want)[0]
    assert not len(bad), f"device regions differ at {pts[bad].tolist()}"
    np.testing.assert_array_equal(
        bx.region_bucket.cpu().numpy()[got], eng._route(pts))
    d = PathServer(eng, batch_size=32).query(s, t)
    fin = np.isfinite(truth)
    err = np.abs(d[fin] - truth[fin])
    bad = np.nonzero(~(err <= 1e-4))[0]
    assert not len(bad), [(s[fin][i].tolist(), t[fin][i].tolist(),
                           float(d[fin][i]), float(truth[fin][i]))
                          for i in bad]
    return int(fin.sum())


def test_cell3_location_on_card_equals_host(card):
    """At cell 3.0 the card locates every boundary point where the host
    routing and the residual table do, and serves every reachable query
    within 1e-4 of the float64 oracle (s = (26.999998, 30) included)."""
    case = cell3_case(card)
    assert check_cell3(*case) > 0


def test_slab_cell3_location_on_card_equals_host(card):
    """The single slab's rows located on the card at cell 3.0 equal its
    residual table's host location on every boundary point."""
    from repro_torch.core.packed import (locate_regions, pack_index,
                                         slab_layout)

    idx, _, _, s, t, _ = cell3_case(card)
    pts = np.concatenate([s, t])
    pk = pack_index(idx, device=card)
    got = locate_regions(pk, torch.from_numpy(pts).to(card)).cpu().numpy()
    res = pack_index(idx, layout=slab_layout("bf16"), device="cpu").residual
    np.testing.assert_array_equal(got, res.locate(pts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,l", [(1, 16), (33, 384), (256, 512)])
def test_label_join_kernel_equals_twin(card, b, l, dtype):
    """The ``label_join`` entry (the row-join kernel, then ``torch.amin``)
    equals ``label_join_ref`` bit for bit, and counts its launches."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(b * 31 + l)
    hs = np.sort(rng.integers(0, 64, (b, l)).astype(np.int32), axis=1)
    ht = np.sort(rng.integers(0, 64, (b, l)).astype(np.int32), axis=1)
    vs = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vt = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vs[rng.random((b, l)) < 0.2] = np.inf
    vt[rng.random((b, l)) < 0.2] = np.inf
    args = [torch.from_numpy(hs).to(card), torch.from_numpy(vs).to(card, dtype),
            torch.from_numpy(ht).to(card), torch.from_numpy(vt).to(card, dtype)]
    before = ops.label_join_kernel.launches
    got = ops.label_join_kernel(*args)
    torch.cuda.synchronize()
    assert ops.label_join_kernel.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b,)
    assert torch.equal(got, ref.label_join_ref(*args))


# ---------------------------------------------------------------------------
# the single slab, the split-phase path and the warmup check on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rooms_s():
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 300, seed=5)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_slab_cuda_engine_equals_torch_and_bucketed(card, rooms_s, layout):
    """Slab CudaEngine == slab TorchEngine == bucketed CudaEngine on all
    five argmin outputs (after the rescue on bf16), and the slab serving
    launches both kernels."""
    from repro_torch.core.packed import pack_index, slab_layout
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    idx, s, t = rooms_s
    lay = slab_layout(layout)
    pk = pack_index(idx, layout=lay, device=card)
    bx = pack_bucketed(idx, layout=lay, device=card)
    seg, join = segvis.launches, label_join_rowmin.launches
    a = PathServer(CudaEngine(pk), batch_size=64)._dispatch(s, t, True)
    assert segvis.launches > seg and label_join_rowmin.launches > join
    b = PathServer(TorchEngine(pk), batch_size=64)._dispatch(s, t, True)
    c = PathServer(CudaEngine(bx), batch_size=64)._dispatch(s, t, True)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


def _eager_engine(art):
    """A CudaEngine that runs eagerly: ``_graphed`` overridden to False, so
    no call replays a CUDA graph."""
    from repro_torch.serving import CudaEngine

    class EagerCudaEngine(CudaEngine):
        def _graphed(self):
            return False

    return EagerCudaEngine(art)


def _artifact(idx, kind: str, device):
    from repro_torch.core.packed import pack_index, slab_layout

    layout, _, packer = kind.partition("-")
    pack = pack_index if packer == "slab" else pack_bucketed
    return pack(idx, layout=slab_layout(layout), device=device)


@pytest.mark.parametrize("kind,argmin", [("f32", False), ("f32", True),
                                         ("bf16", False), ("bf16", True),
                                         ("f32-slab", True)])
def test_async_equals_sync_on_card(card, rooms_s, kind, argmin):
    """Through the batcher (one-query trickles and bursts) the card's
    staged path answers bit for bit as the synchronous path does."""
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    srv = PathServer(CudaEngine(_artifact(idx, kind, card)), batch_size=64)
    srv.warmup(paths=argmin)
    want = srv._dispatch(s, t, want_argmin=argmin)
    tickets = [srv.submit(s[i:i + 1], t[i:i + 1], want_argmin=argmin)
               for i in range(100)]
    tickets.append(srv.submit(s[100:], t[100:], want_argmin=argmin))
    srv.flush()
    assert srv.drain(timeout=120)
    srv.stop_async()
    got = [tk.result(timeout=1) for tk in tickets]
    got = [np.concatenate(col) for col in zip(*got)] if argmin \
        else [np.concatenate(got)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    assert srv.stats.pipeline_peak >= 1
    assert all(b.occupancy <= 1 for b in srv.stats.per_bucket.values())


@pytest.mark.parametrize("kind,argmin", [("f32", False), ("f32", True),
                                         ("bf16", False), ("f32-slab", True)])
def test_dispatch_staged_never_syncs(card, rooms_s, kind, argmin):
    """``dispatch_staged`` issues its batch without one host
    synchronisation (PyTorch's sync debug mode raises on any), behind a
    server that samples every request and with the profile capture timing
    every entry by CUDA events, and the results equal the synchronous
    call's: as a CUDA graph's replay (which calls no entry, so queues no
    timing) and on the eager path of the same engine class (graphs off),
    which times its entries."""
    from repro_torch import obs
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    art = _artifact(idx, kind, card)
    sb, tb = s[:64], t[:64]
    for eng in (CudaEngine(art), _eager_engine(art)):
        reg = obs.MetricsRegistry()
        PathServer(eng, batch_size=64,
                   telemetry=obs.Telemetry(registry=reg, sample_rate=1.0))
        eng.warmup(64, want_argmin=argmin)
        bucket = int(eng.buckets_of(sb, tb).max())
        replays = REGISTRY.total("graph_replays_total", engine=eng.name)
        with obs.profiled(registry=reg, timing=True) as cap:
            staged = eng.stage(sb, tb, bucket)
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = eng.dispatch_staged(staged, bucket,
                                              want_argmin=argmin)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert cap.records == []            # nothing cold after warmup
        got = pending.wait()
        replayed = REGISTRY.total("graph_replays_total",
                                  engine=eng.name) - replays
        if eng._graphed():
            assert replayed == 1 and cap.drain() == 0
        else:
            assert replayed == 0 and cap.drain() > 0
        want = eng.batch_argmin(sb, tb, bucket) if argmin \
            else (eng.batch(sb, tb, bucket),)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)


def test_profile_times_entries_off_the_hot_path(card, rooms_s):
    """With ``timing=True`` every entry call on the card queues a pair of
    CUDA events; ``entry_stream_ms`` appears only once ``drain`` resolves
    them, one sample per call, and the kernel launches add their analytic
    costs (``kernel_cost_*_total``).  The entries run on the eager path
    of the engine class (graphs off); a replayed CUDA graph calls
    none, and adds the kernel costs of the launches it replays."""
    from repro_torch import obs
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    art = _artifact(idx, "f32", card)
    reg = obs.MetricsRegistry()
    srv = PathServer(CudaEngine(art), batch_size=64,
                     telemetry=obs.Telemetry(registry=reg, sample_rate=1.0))
    srv.warmup(paths=True)
    with obs.profiled(registry=reg, timing=True) as cap:
        srv.query(s, t)
        assert cap.drain() == 0                         # replays time none
    assert not reg.series("entry_stream_ms")
    replayed = {dict(m.labels)["kernel"]: m.value
                for m in reg.series("kernel_cost_ops_total")}
    assert set(replayed) == {"segvis", "label_join_rowmin"}
    assert all(v > 0 for v in replayed.values())
    reg = obs.MetricsRegistry()
    srv = PathServer(_eager_engine(art), batch_size=64,
                     telemetry=obs.Telemetry(registry=reg, sample_rate=1.0))
    srv.warmup(paths=True)
    with obs.profiled(registry=reg, timing=True) as cap:
        srv.query(s, t)
        assert not reg.series("entry_stream_ms")        # queued, unread
        resolved = cap.drain()
    torch.cuda.synchronize()
    hist = {dict(h.labels)["entry"]: h for h in reg.series("entry_stream_ms")}
    assert set(hist) == {"fold_endpoint", "join_endpoints"}
    assert sum(h.count for h in hist.values()) == resolved
    assert hist["fold_endpoint"].count == 2 * hist["join_endpoints"].count
    assert all(h.min >= 0 and h.max > 0 for h in hist.values())
    summ = cap.summary()
    assert summ["fold_endpoint"]["stream_calls"] == \
        hist["fold_endpoint"].count
    ops_ = {dict(m.labels)["kernel"]: m.value
            for m in reg.series("kernel_cost_ops_total")}
    assert set(ops_) == {"segvis", "label_join_rowmin"}
    assert all(v > 0 for v in ops_.values())
    (tr, *_) = srv.telemetry.spans.traces("sync")
    assert tr.complete(obs.SYNC_STAGES)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_span_annotations_stay_off_the_device_trace(card, rooms_s, kind):
    """A sampled ``query_paths`` on a ``CudaEngine`` under the profiler:
    the port's span names are on the host timeline, and no CUDA-typed
    event is a user annotation or carries a span's name, so annotations
    never count as device busy time."""
    from repro_torch import obs
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    srv = PathServer(CudaEngine(_artifact(idx, kind, card)), batch_size=64,
                     telemetry=obs.Telemetry(registry=obs.MetricsRegistry(),
                                             sample_rate=1.0))
    srv.warmup(paths=True)
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        srv.query_paths(s, t, host_index=idx)
        torch.cuda.synchronize()
    (tr,) = srv.telemetry.spans.traces("sync")
    names = {sp.name for sp in tr.spans} | set(obs.SYNC_STAGES)
    assert {"engine.launch", "engine.readback"} <= names
    events = prof.events()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device
    assert not [e.key for e in device if e.is_user_annotation]
    assert not {e.key for e in device} & names
    host = {e.key for e in events if e.is_user_annotation}
    assert {"route", "batch.assemble", "batch.scatter", "unwind"} <= host


@pytest.mark.parametrize("kind", ["f32", "bf16", "f32-slab"])
def test_warmup_leaves_nothing_cold_on_card(card, rooms_s, kind):
    """After ``warmup(paths=True)`` live traffic (every bucket, a ragged
    tail, ``query_paths``, the async path, the rescue on bf16) builds and
    loads no kernel and meets no cold shape; a new batch size does."""
    from repro_torch.core.packed import TRACES
    from repro_torch.serving import CudaEngine, PathServer

    idx, s, t = rooms_s
    eng = CudaEngine(_artifact(idx, kind, card))
    srv = PathServer(eng, batch_size=48)
    srv.warmup(paths=True)
    before = cold_counts()
    rescued0 = REGISTRY.total("rescue_batches_total", engine=eng.name)
    segments = torch.cuda.memory_stats()["segment.all.allocated"]
    srv.query(s, t)
    srv.query(s[:7], t[:7])
    srv.query_paths(s[:40], t[:40], host_index=idx)
    for argmin in (False, True):
        tk = srv.submit(s, t, want_argmin=argmin)
        srv.flush()
        tk.result(timeout=120)
    srv.stop_async()
    if kind == "bf16":
        assert REGISTRY.total("rescue_batches_total",
                              engine=eng.name) > rescued0
    after = cold_counts()
    assert after == before, (before, after)
    print(f"allocator segments {segments} -> "
          f"{torch.cuda.memory_stats()['segment.all.allocated']}")
    PathServer(eng, batch_size=37).query(s[:3], t[:3])
    assert TRACES.count > before[0]


# ---------------------------------------------------------------------------
# adaptive indexing on the card: repack aliasing, hot swap, freed memory
# ---------------------------------------------------------------------------

def _adaptive_manager(card, fraction=0.45, layout=None, seed=13):
    from repro_torch.core import bucketed_device_bytes
    from repro_torch.indexing import IndexManager

    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    budget = int(bucketed_device_bytes(idx) * fraction)
    mgr = IndexManager(idx, budget, backend="cuda", device=card,
                       batch_size=32, min_queries=60, replan_threshold=0.10,
                       probe_n=32, seed=seed, validate_tol=0.0,
                       layout=layout)
    return mgr, budget, scene, graph


def _cluster(scene, graph, n, seed):
    from repro_torch.core import cluster_queries

    qs = cluster_queries(scene, graph, 2, n, seed=seed, require_path=False)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


def _kept_tensors(art):
    """The artifact's device tensors a repack does not alias."""
    import dataclasses

    out = []
    for f in dataclasses.fields(art):
        if f.name in ("edges_a", "edges_b", "edges_c", "grid"):
            continue
        v = getattr(art, f.name)
        out += [x for x in (v if isinstance(v, tuple) else (v,))
                if isinstance(x, torch.Tensor)]
    return out


def _graph_tensors(eng):
    """The static endpoints and outputs of an engine's CUDA graphs."""
    return [x for g in eng._graphs.values() for x in (g.s, g.t, *g.outs)]


def test_swap_frees_retired_artifact_on_card(card):
    """A swap with nothing pinned drops the retired artifact: after
    ``gc.collect()`` ``memory_allocated()`` has fallen, beside what the new
    artifact and its engine's CUDA graphs hold, by at least the old one's
    unaliased bytes, and nothing references its slabs."""
    import gc
    import weakref

    mgr, budget, scene, graph = _adaptive_manager(card)
    mgr.recorder.record(*_cluster(scene, graph, 150, seed=31))
    old = mgr.engine.artifact
    edges = sum(x.numel() * x.element_size()
                for x in (old.edges_a, old.edges_b, old.edges_c))
    unaliased = old.device_bytes() - edges
    ref_slab = weakref.ref(old.hub_ids[0])
    del old
    gc.collect()
    m0 = torch.cuda.memory_allocated(card)
    assert mgr.maybe_adapt() is True
    gc.collect()
    m1 = torch.cuda.memory_allocated(card)
    new_alloc = sum(-(-x.untyped_storage().nbytes() // 512) * 512
                    for x in _kept_tensors(mgr.engine.artifact)
                    + _graph_tensors(mgr.engine.current))
    assert ref_slab() is None
    assert m0 + new_alloc - m1 >= unaliased, (m0, m1, new_alloc, unaliased)
    assert mgr.engine.drops == 1 and mgr.device_bytes() <= budget


@pytest.mark.parametrize("case", ["dense", "grid"])
def test_reuse_edges_aliases_on_card(card, case):
    """``pack_bucketed(reuse_edges_from=)`` aliases the card's edge tensors
    (and the grid of rooms-S seed 0, whose serving then launches
    ``segvis_tiles``); the repacked artifact answers as a fresh pack, bit
    for bit."""
    from repro_torch.serving import CudaEngine, PathServer

    scene = make_map("rooms-S", seed=1 if case == "dense" else 0)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    prev = pack_bucketed(idx, device=card)
    assert (prev.grid is not None) == (case == "grid")
    compress_to_fraction(idx, 0.3)
    bx = pack_bucketed(idx, reuse_edges_from=prev, device=card)
    for k in ("edges_a", "edges_b", "edges_c"):
        assert getattr(bx, k).data_ptr() == getattr(prev, k).data_ptr()
    assert bx.grid is prev.grid
    qs = uniform_queries(scene, graph, 200, seed=5, require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    tiles = segvis_tiles.launches
    got = PathServer(CudaEngine(bx), batch_size=64)._dispatch(s, t, True)
    assert (segvis_tiles.launches > tiles) == (case == "grid")
    want = PathServer(CudaEngine(pack_bucketed(idx, device=card)),
                      batch_size=64)._dispatch(s, t, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="lives on"):
        pack_bucketed(idx, reuse_edges_from=prev, device="cpu")


def test_background_adapt_while_serving_on_card(card):
    """``maybe_adapt(block=False)`` builds, validates, warms and swaps on
    the manager's thread while ``PathServer.query`` serves on this one;
    every answer of every pass stays within 1e-4 of the float64 oracle."""
    from repro_torch.core.query import query as host_query
    from repro_torch.serving import PathServer

    mgr, budget, scene, graph = _adaptive_manager(card, fraction=0.5,
                                                  seed=29)
    srv = PathServer(mgr.engine, batch_size=32, recorder=mgr.recorder)
    srv.warmup()
    s, t = _cluster(scene, graph, 120, seed=61)
    truth = np.array([host_query(mgr.host_index, a, b, want_path=False)[0]
                      for a, b in zip(s, t)])
    srv.query(s, t)
    assert mgr.maybe_adapt(block=False) is False
    passes = 0
    while True:
        building = mgr.building
        d = srv.query(s, t)
        passes += 1
        fin = np.isfinite(truth)
        np.testing.assert_array_equal(np.isfinite(d), fin)
        np.testing.assert_allclose(d[fin], truth[fin], rtol=1e-4, atol=1e-4)
        if not building:
            break
    mgr.join(timeout=120)
    assert passes >= 2 and mgr.swaps == 1 and mgr.validation_failures == 0
    assert mgr.device_bytes() <= budget
    assert srv.stats.generation == mgr.generation


def test_bf16_manager_swap_winners_equal_f32_on_card(card):
    """A bf16 manager swaps (probe tolerance widened by the generations'
    quantization bounds), and the swapped-in artifact's argmin winners,
    after the residual rescue, equal the f32 engine's on the same regions
    bit for bit."""
    from repro_torch.serving import CudaEngine, PathServer

    mgr, budget, scene, graph = _adaptive_manager(card, fraction=0.2,
                                                  layout="bf16")
    mgr.recorder.record(*_cluster(scene, graph, 150, seed=31))
    assert mgr.maybe_adapt() is True and mgr.validation_failures == 0
    assert mgr.device_bytes() <= budget and mgr.engine.artifact.layout.quantized
    s, t = _cluster(scene, graph, 200, seed=7)
    q = PathServer(mgr.engine, batch_size=64)._dispatch(s, t, True)
    f32 = PathServer(CudaEngine(pack_bucketed(mgr.host_index, device=card)),
                     batch_size=64)._dispatch(s, t, True)
    for a, b in zip(q[1:], f32[1:]):
        np.testing.assert_array_equal(a, b)
    qerr = float(mgr.engine.artifact.qerr)
    fin = np.isfinite(f32[0])
    np.testing.assert_array_equal(np.isfinite(q[0]), fin)
    assert np.all(np.abs(q[0][fin] - f32[0][fin]) <= 2 * qerr + 1e-4)


def test_two_threads_load_a_cold_kernel_once_on_card(card, tmp_path,
                                                     monkeypatch):
    """Two threads that meet ``label_join`` first on a cold build cache
    make one nvcc build and one load between them, and both launch."""
    import threading

    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    builds0, loads0 = (REGISTRY.total(n, kernel="label_join") for n in
                       ("kernel_builds_total", "kernel_loads_total"))
    rng = np.random.default_rng(3)
    rows = [torch.from_numpy(a).to(card) for a in (
        np.sort(rng.integers(0, 9, (4, 128)), axis=1).astype(np.int32),
        rng.uniform(0, 9, (4, 128)).astype(np.float32),
        np.sort(rng.integers(0, 9, (4, 128)), axis=1).astype(np.int32),
        rng.uniform(0, 9, (4, 128)).astype(np.float32))]
    start = threading.Barrier(2)
    out, errors = [], []

    def first_use():
        try:
            start.wait()
            out.append(label_join_rowmin(*rows))
            torch.cuda.synchronize()
        except BaseException as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not errors, errors
    assert REGISTRY.total("kernel_builds_total", kernel="label_join") == \
        builds0 + 1
    assert REGISTRY.total("kernel_loads_total", kernel="label_join") == \
        loads0 + 1
    want = ref.label_join_rowmin_ref(*rows)
    assert all(torch.equal(o, want) for o in out) and len(out) == 2


# ---------------------------------------------------------------------------
# region sharding on the card: every shard on one card (round-robin)
# ---------------------------------------------------------------------------

def _sharded(idx, layout: str, device, edge_grid=None):
    from repro_torch.core.packed import slab_layout
    from repro_torch.sharding import ShardPlanner

    return ShardPlanner(4, layout=slab_layout(layout)).build(
        idx, edge_grid=edge_grid, device=device)


@pytest.mark.parametrize("layout,edge_grid", [("f32", None), ("bf16", None),
                                              ("f32", True)])
def test_sharded_kernel_engine_equals_twin_engine(card, rooms_s, layout,
                                                  edge_grid):
    """The sharded engine on the kernels == the sharded twin engine on all
    5 outputs (the rescue included on bf16), and on f32 == the single-device
    CudaEngine, through PathServer and ``query``; the clipped grids launch
    ``segvis_tiles``."""
    from repro_torch.serving import CudaEngine, PathServer
    from repro_torch.sharding import ShardedQueryEngine

    idx, s, t = rooms_s
    sh = _sharded(idx, layout, card, edge_grid)
    assert {str(d) for d in sh.devices} == {"cuda:0"}
    tiles = segvis_tiles.launches
    kern = ShardedQueryEngine(sh, backend="cuda")
    a = PathServer(kern, batch_size=64)._dispatch(s, t, True)
    b = PathServer(ShardedQueryEngine(sh, backend="torch"),
                   batch_size=64)._dispatch(s, t, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    if edge_grid:
        assert segvis_tiles.launches > tiles
    if layout == "f32":
        c = PathServer(CudaEngine(pack_bucketed(idx, device=card)),
                       batch_size=64)._dispatch(s, t, True)
        for x, z in zip(a, c):
            np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(kern.query(s, t), a[0])


@pytest.mark.parametrize("layout,argmin", [("f32", False), ("f32", True),
                                           ("bf16", False)])
def test_sharded_dispatch_staged_never_syncs(card, rooms_s, layout, argmin):
    """The sharded ``dispatch_staged`` issues a cross-shard group (folds,
    covis on every participant, the wire on bf16, the join) without one
    host synchronisation (a quantized argmin's flag read is the sanctioned
    one, left out as in ``test_dispatch_staged_never_syncs``), and the
    results equal the synchronous call's."""
    from repro_torch.sharding import ShardedQueryEngine

    idx, s, t = rooms_s
    eng = ShardedQueryEngine(_sharded(idx, layout, card), backend="cuda")
    eng.warmup(64, want_argmin=argmin)
    keys = eng.buckets_of(s, t)
    cross = [k for k in np.unique(keys)
             if eng.router.decode_key(k)[0] != eng.router.decode_key(k)[1]]
    key = max(cross, key=lambda k: int((keys == k).sum()))
    sel = np.nonzero(keys == key)[0][:64]
    sb = np.zeros((64, 2), np.float32)
    tb = np.zeros((64, 2), np.float32)
    sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
    staged = eng.stage(sb, tb, key)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = eng.dispatch_staged(staged, key, want_argmin=argmin)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = pending.wait()
    want = eng.batch_argmin(sb, tb, key) if argmin \
        else (eng.batch(sb, tb, key),)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def _one_batch(eng, s, t, rows: int = 64):
    """The busiest routing key's first ``rows`` queries, padded."""
    keys = eng.buckets_of(s, t)
    key = int(max(np.unique(keys), key=lambda k: int((keys == k).sum())))
    sel = np.nonzero(keys == key)[0][:rows]
    sb = np.zeros((rows, 2), np.float32)
    tb = np.zeros((rows, 2), np.float32)
    sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
    return sb, tb, key


@pytest.mark.parametrize("engine", ["dense", "sharded"])
@pytest.mark.parametrize("layout,argmin", [("f32", False), ("f32", True),
                                           ("bf16", True)])
def test_staged_syncs_sit_at_marked_lines(card, rooms_s, engine, layout,
                                          argmin):
    """chip_smoke's ``syncs:`` check at rooms-S, batch 64: one batch's
    ``stage`` + ``dispatch_staged`` under the sync debug mode ("warn"),
    each reported sync attributed to its line on the hot path.  The f32
    engines (dense and four shards) see none; on bf16 every sync (the
    argmin's flag read, a rescue) sits at a ``hot-path-sync`` marker; the
    answers equal the synchronous call's."""
    from repro_torch.analysis.syncs import record_syncs, unmarked
    from repro_torch.serving import CudaEngine
    from repro_torch.sharding import ShardedQueryEngine

    idx, s, t = rooms_s
    eng = (CudaEngine(_artifact(idx, layout, card)) if engine == "dense"
           else ShardedQueryEngine(_sharded(idx, layout, card),
                                   backend="cuda"))
    eng.warmup(64, want_argmin=argmin)
    sb, tb, key = _one_batch(eng, s, t)
    pending, sites = record_syncs(
        lambda: eng.dispatch_staged(eng.stage(sb, tb, key), key,
                                    want_argmin=argmin))
    got = pending.wait()
    assert unmarked(sites) == [], [x.render() for x in sites]
    if layout == "f32":
        assert sites == [], [x.render() for x in sites]
    else:
        assert sites, "the quantized argmin read no ambiguity flag"
    want = eng.batch_argmin(sb, tb, key) if argmin \
        else (eng.batch(sb, tb, key),)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_sharded_warmup_leaves_nothing_cold_on_card(card, rooms_s, layout):
    """After ``warmup(paths=True)`` the sharded engine's live traffic
    (every routing key, a ragged tail, ``query_paths``, the batcher, the
    rescue and the quantized wire on bf16) builds and loads no kernel and
    meets no cold shape."""
    from repro_torch.serving import PathServer
    from repro_torch.sharding import ShardedQueryEngine

    idx, s, t = rooms_s
    eng = ShardedQueryEngine(_sharded(idx, layout, card), backend="cuda")
    srv = PathServer(eng, batch_size=48)
    srv.warmup(paths=True)
    before = cold_counts()
    srv.query(s, t)
    srv.query(s[:7], t[:7])
    srv.query_paths(s[:40], t[:40], host_index=idx)
    for argmin in (False, True):
        tk = srv.submit(s, t, want_argmin=argmin)
        srv.flush()
        tk.result(timeout=120)
    srv.stop_async()
    if layout == "bf16":
        assert eng.rescue_batches > 0
    after = cold_counts()
    assert after == before, (before, after)
    assert len(srv.stats.per_shard) == 4


def check_cell3_sharded(idx, s, t, truth, device):
    """The sharded engine at cell 3.0: the router's host cells send every
    endpoint to the shard and local region where the owning shard's own
    mapper (the rescue's ``locate_regions``) locates it on the device, and
    every query the oracle reaches is served within 1e-4 of it, bit for bit
    as the single-device bucketed engine serves it."""
    from repro_torch.core.packed import locate_regions
    from repro_torch.serving import CudaEngine, PathServer
    from repro_torch.sharding import ShardedQueryEngine, ShardPlanner

    sh = ShardPlanner(4).build(idx, device=device)
    eng = ShardedQueryEngine(sh, backend="cuda")
    pts = np.concatenate([s, t])
    cells = eng.router._cells(pts)
    owner = sh.cell_shard[cells]
    for k, bx in enumerate(sh.shards):
        m = owner == k
        got = locate_regions(bx, torch.from_numpy(pts[m]).to(bx.device))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      sh.cell_local[cells[m]])
    d = PathServer(eng, batch_size=32).query(s, t)
    fin = np.isfinite(truth)
    err = np.abs(d[fin] - truth[fin])
    assert np.all(err <= 1e-4), float(err.max())
    want = PathServer(CudaEngine(pack_bucketed(idx, device=device)),
                      batch_size=32).query(s, t)
    np.testing.assert_array_equal(d, want)
    return int(fin.sum())


def test_cell3_sharded_location_on_card(card):
    """At cell 3.0 the sharded engine's host routing agrees with every
    shard's device location and serves the boundary queries as the
    single-device engine and the float64 oracle do."""
    idx, _, _, s, t, truth = cell3_case(card)
    assert check_cell3_sharded(idx, s, t, truth, card) > 0


# ---------------------------------------------------------------------------
# the LM port (repro_torch.models) on the card, reduced families
# ---------------------------------------------------------------------------

LM_DECODE_ARCHS = ["tinyllama-1.1b", "deepseek-v3-671b", "gemma2-27b",
                   "mamba2-780m", "hymba-1.5b", "whisper-large-v3"]


@pytest.fixture
def full_f32(card):
    """float32 matmuls in full precision (no TF32) while a test runs."""
    tf32, prec = (torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield card
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _lm_case(arch, B, S, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, seed, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    enc = (torch.from_numpy(rng.standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
        if cfg.encdec else None)
    return cfg, params, toks, enc


@pytest.mark.parametrize("arch", [
    "llama4-scout-17b-a16e", "deepseek-v3-671b", "tinyllama-1.1b",
    "nemotron-4-340b", "gemma2-27b", "gemma3-12b", "hymba-1.5b",
    "mamba2-780m", "qwen2-vl-72b", "whisper-large-v3"])
def test_lm_reduced_forward_card_equals_cpu(full_f32, arch):
    """The same float32 parameters give the same logits on the card and on
    the CPU (rtol 1e-4, atol 1e-5 times the larger of 1 and the logits'
    largest magnitude, as the CPU tests hold the port to the reference)."""
    from repro_torch.models import transformer as T

    cfg, params, toks, enc = _lm_case(arch, 2, 32)
    want = T.forward(cfg, params, toks, enc_frames=enc)
    got = T.forward(cfg, T.to_device(params, full_f32), toks.to(full_f32),
                    enc_frames=None if enc is None else enc.to(full_f32))
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("arch", LM_DECODE_ARCHS)
def test_lm_reduced_decode_equals_forward_on_card(full_f32, arch):
    """Stepped decode equals forward on the card at the reference test's
    rtol 2e-3 and atol 2e-4."""
    from repro_torch.models import transformer as T

    B, S = 2, 16
    cfg, params, toks, enc = _lm_case(arch, B, S)
    params = T.to_device(params, full_f32)
    toks = toks.to(full_f32)
    enc = None if enc is None else enc.to(full_f32)
    full = T.forward(cfg, params, toks, enc_frames=enc)
    enc_out = T.encode(cfg, params, enc) if cfg.encdec else None
    cache = T.init_cache(cfg, B, S, dtype=torch.float32, enc_out=enc_out,
                         params=params, device=full_f32)
    outs = []
    for i in range(S):
        lg, cache = T.decode_step(cfg, params, cache, toks[:, i:i + 1])
        outs.append(lg)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-3,
                               atol=2e-4)


def test_lm_server_on_card_equals_cpu(full_f32):
    """Greedy tokens of the card's LMServer equal the CPU's (float32)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import LMServer

    cfg, params, toks, _ = _lm_case("tinyllama-1.1b", 2, 6)
    prompt = toks.numpy().astype(np.int32)
    got = {}
    for dev in ("cpu", full_f32):
        srv = LMServer(cfg, params, T.init_cache(cfg, 2, 16,
                                                 dtype=torch.float32,
                                                 device=dev), device=dev)
        for i in range(prompt.shape[1] - 1):
            srv.cache = srv._step(srv.params, srv.cache, torch.from_numpy(
                prompt[:, i:i + 1]).to(dev))[1]
        got[str(dev)] = srv.generate(prompt, 8)
        assert srv.stats.queries == 16
    a, b = got.values()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b",
                                  "mamba2-780m"])
def test_lm_reduced_train_step_card_equals_cpu(full_f32, arch):
    """One ``build_train_step`` step on the card equals the CPU's on the
    same float32 parameters and batch: the loss, the gradient norm and
    the new moments within rtol 1e-4 and atol 1e-5 times the larger of 1
    and the leaf's largest magnitude (5e-5 on mamba2, as the CPU gradient
    tests); the new parameters within rtol 1e-6 and atol 1e-6 times it,
    except where the first moment is under 1e-6 (there the first AdamW
    step's sign-like update is held within 2 lr, as the CPU integration
    test does)."""
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    cfg, params, toks, _ = _lm_case(arch, 2, 32)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=16)
    step = build_train_step(cfg, ocfg)
    atol = 5e-5 if arch == "mamba2-780m" else 1e-5
    out = []
    for dev in ("cpu", full_f32):
        p = T.to_device(params, dev)
        out.append(step(p, adamw.init_state(p, ocfg), toks.to(dev)))
    (wp, ws, wm), (gp, gs, gm) = out

    def close(got, want, rtol, atol_):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, rtol=rtol,
                                   atol=atol_ * scale)

    for k in ("loss", "grad_norm", "lr"):
        close(gm[k], wm[k], 1e-4, atol)
    for k, w in flatten({"m": ws["m"], "v": ws["v"]}).items():
        close(flatten({"m": gs["m"], "v": gs["v"]})[k], w, 1e-4, atol)
    lr = float(wm["lr"])
    for k, w in flatten(wp).items():
        g = flatten(gp)[k].cpu()
        flat_m = flatten(ws["m"])[k].abs() < 1e-6
        close(g[~flat_m], w[~flat_m], 1e-6, 1e-6)
        off = (g[flat_m] - w[flat_m]).abs()
        assert off.numel() == 0 or float(off.max()) <= 2 * lr, k


def test_bf16_checkpoint_round_trip_on_card(card, tmp_path):
    """bf16 parameters saved from the card (their bits as ``|V2``,
    ``bfloat16`` in the manifest) restore onto the card bit for bit."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    cfg = get_config("tinyllama-1.1b").reduced()
    params = T.init_params(cfg, 3, dtype=torch.bfloat16, device=card)
    tree = {"p": params, "o": adamw.init_state(params, adamw.AdamWConfig())}
    store.save(str(tmp_path), 3, tree)
    out = store.restore(str(tmp_path), store.latest_step(str(tmp_path)),
                        tree, device=card)
    for k, v in flatten(tree).items():
        got = flatten(out)[k]
        assert got.device == v.device and got.dtype == v.dtype, k
        if v.dtype == torch.bfloat16:
            got, v = got.view(torch.int16), v.view(torch.int16)
        assert torch.equal(got, v), k


# ------------------------------------------------- the distributed half

@pytest.fixture
def card_mesh(full_f32):
    """A one-rank ("data", "model") NCCL mesh on the card (the process's
    default group, made on first use)."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device=full_f32)


def test_mesh_train_step_on_card_equals_one_device(card_mesh):
    """tinyllama reduced on a one-rank NCCL mesh: DTensor parameters from
    ``param_shardings``, the batch from ``global_batch_arrays``; three
    ``build_train_step`` steps' losses and the first step's gradients
    within rtol 1e-5 and atol 1e-6 times the larger of 1 and the leaf's
    largest magnitude of the one-device step (one rank runs the same local
    ops)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, global_batch_arrays,
                                           synthetic_batch)
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_shardings,
                                                  undistribute)
    from repro_torch.launch.train import (build_train_step, host_float,
                                          loss_and_grads, on_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    dev = torch.device("cuda", 0)
    cfg = get_config("tinyllama-1.1b").reduced()
    params = T.init_params(cfg, 0, dtype=torch.float32, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    mesh = card_mesh
    dp = distribute(params, mesh, param_shardings(params, mesh))
    spec = batch_spec(mesh)

    def close(got, want):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)

    tok = torch.from_numpy(synthetic_batch(dcfg, 0)).to(dev)
    wl, wg = loss_and_grads(cfg, params, tok)
    with on_mesh(mesh):
        gl, gg = loss_and_grads(cfg, dp, global_batch_arrays(dcfg, 0, mesh,
                                                             spec))
    close(gl.full_tensor(), wl)
    for k, w in flatten(wg).items():
        close(flatten(undistribute(gg))[k], w)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=8)
    one, on = build_train_step(cfg, ocfg), build_train_step(cfg, ocfg,
                                                            mesh=mesh)
    so, sm = adamw.init_state(params, ocfg), adamw.init_state(dp, ocfg)
    for i in range(3):
        params, so, mo = one(params, so, torch.from_numpy(
            synthetic_batch(dcfg, i)).to(dev))
        dp, sm, mm = on(dp, sm, global_batch_arrays(dcfg, i, mesh, spec))
        close(torch.tensor(host_float(mm["loss"])),
              torch.tensor(host_float(mo["loss"])))


@pytest.mark.parametrize("pos,window,cap", [(17, 0, 0.0), (9, 5, 30.0),
                                            (31, 0, 50.0)])
def test_flash_decode_dist_on_card(card_mesh, pos, window, cap):
    """``decode_attention_dist`` on a one-rank mesh == ``decode_attention``
    plus the slot write (< 1e-5, the reference test's tolerance; the
    caches bit for bit)."""
    from repro_torch.distributed import hints
    from repro_torch.distributed.flash_decode import decode_attention_dist
    from repro_torch.models import layers as ll

    g = torch.Generator(device="cuda")
    g.manual_seed(pos)
    B, Smax, K, H, hd = 4, 32, 3, 6, 16
    q, kc, vc, kn, vn = (torch.randn(s, generator=g, device="cuda")
                         for s in ((B, 1, H, hd), (B, Smax, K, hd),
                                   (B, Smax, K, hd), (B, 1, K, hd),
                                   (B, 1, K, hd)))
    with hints.mesh_hints(card_mesh):
        od, kd, vd = decode_attention_dist(q, kc, vc, kn, vn, pos,
                                           window=window, softcap=cap)
    kr, vr = kc.clone(), vc.clone()
    kr[:, pos], vr[:, pos] = kn[:, 0], vn[:, 0]
    want = ll.decode_attention(q, kr, vr, pos + 1, window=window,
                               softcap=cap)
    assert float((od - want).abs().max()) < 1e-5
    assert torch.equal(kd, kr) and torch.equal(vd, vr)


def test_moe_block_ep_on_card(card_mesh):
    """``moe_block_ep`` (deepseek-v3 reduced) on a one-rank mesh against
    ``moe_block``: forward < 1e-4, gradients < 1e-5 (the reference test's
    tolerances); the forward ran two all-to-alls."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.distributed import hints
    from repro_torch.distributed.moe_ep import moe_block_ep
    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, unflatten

    dev = torch.device("cuda", 0)
    cfg = get_config("deepseek-v3-671b").reduced()
    p = T._layer(ll.init_moe(cfg, ll.ParamInit(dev, 0), 1, torch.float32), 0)
    x = torch.randn((4, 16, cfg.d_model), device=dev)
    cap = 1 << 20

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten(p).items()}
        with hints.mesh_hints(card_mesh):
            out = fn(unflatten(leaves))
        g = torch.autograd.grad((out ** 2).mean(), list(leaves.values()))
        return out.detach(), dict(zip(leaves, g))

    with CommDebugMode() as comm, torch.no_grad(), \
            hints.mesh_hints(card_mesh):
        moe_block_ep(cfg, p, x, cap)
    assert sum(n for op, n in comm.get_comm_counts().items()
               if "all_to_all" in str(op)) == 2
    y, g1 = grads(lambda q: moe_block_ep(cfg, q, x, cap))
    want, g2 = grads(lambda q: ll.moe_block(cfg, q, x, cap))
    assert float((y - want).abs().max()) < 1e-4
    assert max(float((g1[k] - g2[k]).abs().max()) for k in g1) < 1e-5


def test_batch_sharding_server_on_card(card, rooms_s):
    """``PathServer(mesh=(cuda:0, cuda:0), batch_sharding="rows")`` == the
    unsharded server bit for bit (distances and all five argmin outputs),
    and its warmup leaves nothing cold for live traffic."""
    from repro_torch.serving import CudaEngine, PathServer
    from repro_torch.serving.engine import BATCH_ROWS

    idx, s, t = rooms_s
    bx = pack_bucketed(idx, device=card)
    plain = PathServer(CudaEngine(bx), batch_size=64)
    split = PathServer(CudaEngine(bx), batch_size=64, mesh=(card, card),
                       batch_sharding=BATCH_ROWS)
    split.warmup(paths=True)
    before = cold_counts()
    got = split._dispatch(s, t, want_argmin=True)
    assert cold_counts() == before
    for a, b in zip(got, plain._dispatch(s, t, want_argmin=True)):
        assert np.array_equal(a, b)
    np.testing.assert_array_equal(split.query(s, t), plain.query(s, t))
    with pytest.raises(ValueError):
        split.start_async()
