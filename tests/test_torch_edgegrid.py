"""Port edge-grid path vs the JAX reference (DESIGN.md §10, CPU).

The same numpy inputs go through ``repro.core.edgegrid`` / the reference
kernels and their port counterparts: grid planes, the cell walk and the
gathered tiles must be equal, and every visibility verdict must be equal —
to the reference's grid path, to its Pallas ``segvis_tiles`` kernel in
interpret mode, and to the port's own dense predicate.  Then the slice as a
whole: the port's engines on a forced-grid artifact answer as the
reference's grid artifact does, and bit for bit as the port's dense one.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import edgegrid as ref_edgegrid
from repro.core import packed as ref_packed
from repro.kernels import ref as jref
from repro.kernels.segvis import segvis_tiles as pallas_segvis_tiles
from repro_torch.core import edgegrid as port_edgegrid
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.query import path_length
from repro_torch.core.visgraph import build_visgraph
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segvis_tiles as cuda_segvis_tiles
from repro_torch.serving import CudaEngine, PathServer, TorchEngine

HOST_TOL = 1e-4
TARGETS = [None, 16]        # auto resolution and a finer forced one
ANSWERS = ("d", "covis", "via_s", "hub", "via_t")


# ---------------------------------------------------------------------------
# segvis_tiles: port twin == reference oracle == Pallas kernel (interpret)
# ---------------------------------------------------------------------------

def _tile_case(rng, n, s):
    """[N,2] endpoints and six [N,S] planes with the contact classes: zero
    padded slots, degenerate edges, endpoints on slot vertices and on open
    slot edges."""
    p = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    q = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    a, b, c = (rng.uniform(0, 10, (n, s, 2)).astype(np.float32)
               for _ in range(3))
    pad = rng.random((n, s)) < 0.25
    a[pad] = b[pad] = c[pad] = 0.0                  # zero-padded slots
    degen = rng.random((n, s)) < 0.1
    b[degen] = a[degen]                             # degenerate edges
    rows = np.arange(n)
    k = rng.integers(0, s, n)
    on_vertex = rng.random(n) < 0.3
    q[on_vertex] = a[rows, k][on_vertex]            # ends on a slot vertex
    on_edge = ~on_vertex & (rng.random(n) < 0.4)
    mid = ((a[rows, k] + b[rows, k]) / 2).astype(np.float32)
    q[on_edge] = mid[on_edge]                       # ends on an open edge
    p[::5] = b[rows, k][::5]                        # starts on a vertex
    planes = [x[..., i] for x in (a, b, c) for i in (0, 1)]
    return [p, q] + [np.ascontiguousarray(x) for x in planes]


@pytest.mark.parametrize("n", [1, 7, 300])
@pytest.mark.parametrize("s", [1, 33, 96, 600])
def test_segvis_tiles_twin_matches_jax(n, s):
    args = _tile_case(np.random.default_rng(n * 1000 + s), n, s)
    port = ref.segvis_tiles_ref(*map(torch.from_numpy, args)).numpy()
    j = [jnp.asarray(a) for a in args]
    np.testing.assert_array_equal(port, np.asarray(jref.segvis_tiles_ref(*j)))
    np.testing.assert_array_equal(
        port, np.asarray(pallas_segvis_tiles(*j, interpret=True)))
    # the predicate really sees blocked and visible segments here
    if n >= 300:
        assert 0 < port.sum() < n


def test_segvis_tiles_dispatch_and_wrapper_guard():
    """CPU tensors run the twin and count no launch; the CUDA wrapper
    refuses them rather than falling back."""
    args = [torch.from_numpy(a)
            for a in _tile_case(np.random.default_rng(3), 9, 40)]
    launches = cuda_segvis_tiles.segvis_tiles.launches
    calls = ref.segvis_tiles_ref.calls
    assert torch.equal(ops.segvis_tiles_kernel(*args),
                       ops.segvis_tiles_ref(*args))
    assert ref.segvis_tiles_ref.calls == calls + 2
    assert cuda_segvis_tiles.segvis_tiles.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_segvis_tiles.segvis_tiles(*args)


# ---------------------------------------------------------------------------
# walk + gather on rooms-S
# ---------------------------------------------------------------------------

def _grids(scene, target_cells):
    """(reference grid, port grid, packed edges as numpy) of one scene."""
    ea, eb, ec = port_packed._pack_edges(scene, lane=128)
    E = scene.edges.shape[0]
    kw = dict(sentinel=ea.shape[0] - 1, target_cells=target_cells)
    want = ref_edgegrid.build_edge_grid(ea, eb, E, scene.width,
                                        scene.height, **kw)
    got = port_edgegrid.build_edge_grid(ea, eb, E, scene.width,
                                        scene.height, device="cpu", **kw)
    return want, got, (ea, eb, ec)


def _segments(scene, gcell, seed=0, n=300):
    """Boundary-snapped random segments, axis-aligned, zero-length and
    map-crossing ones, and free point -> obstacle vertex (the engine's own
    segment population)."""
    rng = np.random.default_rng(seed)
    w, h = scene.width, scene.height
    pts = rng.uniform(0, [w, h], (2 * n, 2)).astype(np.float32)
    g = np.float32(gcell)
    snap = rng.random((2 * n, 2)) < 0.5
    pts = np.where(snap, np.round(pts / g) * g, pts).astype(np.float32)
    p, q = pts[:n], pts[n:]
    p[0], q[0] = (0.0, 0.0), (w, h)                     # map-crossing
    p[1], q[1] = (w, 0.0), (0.0, h)
    p[2], q[2] = (gcell, 1.0), (gcell, h - 1.0)         # on a column line
    p[3], q[3] = (1.0, gcell), (w - 1.0, gcell)         # on a row line
    p[4] = q[4] = (gcell * 2, gcell * 3)                # zero-length, corner
    p[5] = q[5] = (1.5, 2.5)                            # zero-length
    p[6], q[6] = (3.0, 0.5), (3.0, 9.0)                 # axis-aligned
    p[7], q[7] = (0.5, 4.0), (9.0, 4.0)
    V = scene.vertices.astype(np.float32)
    P = rng.uniform(0, [w, h], V.shape).astype(np.float32)
    return (np.concatenate([p, P]).astype(np.float32),
            np.concatenate([q, V]).astype(np.float32))


@pytest.fixture(scope="module", params=TARGETS, ids=lambda t: f"cells{t}")
def walk_case(request, scene_s):
    want, got, edges = _grids(scene_s, request.param)
    p, q = _segments(scene_s, want.gcell)
    return want, got, edges, p, q


def test_build_edge_grid_planes_equal_reference(walk_case):
    want, got, *_ = walk_case
    for k in ("cell_ids", "cell_len"):
        g = getattr(got, k).numpy()
        assert g.dtype == np.int32, k
        np.testing.assert_array_equal(g, np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("gnx", "gny", "gcell", "sentinel", "eps", "num_cells",
              "ell_width", "walk_slots", "tile_slots"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.device_bytes() == want.device_bytes()


def test_build_edge_grid_defaults_to_the_card(scene_s, monkeypatch):
    """Like every entry point of the port, ``build_edge_grid`` runs on the
    card unless the caller asks for the CPU: with no ``device`` and no
    card it raises, and ``device="cpu"`` builds on the CPU."""
    ea, eb, _ = port_packed._pack_edges(scene_s, lane=128)
    args = (ea, eb, scene_s.edges.shape[0], scene_s.width, scene_s.height)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_edgegrid.build_edge_grid(*args, sentinel=ea.shape[0] - 1)
    grid = port_edgegrid.build_edge_grid(*args, sentinel=ea.shape[0] - 1,
                                         device="cpu")
    assert grid.cell_ids.device.type == "cpu"


def test_plan_grid_matches_reference(scene_s):
    ea, eb, _ = port_packed._pack_edges(scene_s, lane=128)
    E = scene_s.edges.shape[0]
    for target in TARGETS + [4, 64]:
        args = (ea, eb, E, scene_s.width, scene_s.height, target)
        assert port_edgegrid.plan_grid(*args) == \
            ref_edgegrid.plan_grid(*args)
        assert port_edgegrid.plan_grid_bytes(*args) == \
            ref_edgegrid.plan_grid_bytes(*args)
    assert port_edgegrid.ell_bytes(8, 8, 4) == ref_edgegrid.ell_bytes(8, 8, 4)


def test_visited_cells_equal_reference(walk_case):
    want, got, _, p, q = walk_case
    cells = got.visited_cells(torch.from_numpy(p), torch.from_numpy(q))
    assert cells.dtype == torch.int32
    np.testing.assert_array_equal(
        cells.numpy(),
        np.asarray(want.visited_cells(jnp.asarray(p), jnp.asarray(q))))
    np.testing.assert_array_equal(got.edges_touched(p, q),
                                  want.edges_touched(p, q))


def test_walk_visits_every_touched_cell(walk_case):
    """Superset half of the §10 argument, on the port's own walk."""
    _, grid, _, p, q = walk_case
    cells = grid.visited_cells(torch.from_numpy(p), torch.from_numpy(q))
    ts = np.linspace(0.0, 1.0, 512)[None, :, None]
    pts = p[:, None, :] + ts * (q - p)[:, None, :]
    ix = np.clip((pts[..., 0] / grid.gcell).astype(int), 0, grid.gnx - 1)
    iy = np.clip((pts[..., 1] / grid.gcell).astype(int), 0, grid.gny - 1)
    touched = iy * grid.gnx + ix
    for i, row in enumerate(cells.numpy()):
        assert not set(touched[i]) - set(row), f"segment {i}"


def test_gather_edge_tiles_equal_reference(walk_case):
    want, got, (ea, eb, ec), p, q = walk_case
    tiles = port_edgegrid.gather_edge_tiles(
        got, *map(torch.from_numpy, (ea, eb, ec, p, q)))
    ref_tiles = ref_edgegrid.gather_edge_tiles(
        want, *map(jnp.asarray, (ea, eb, ec, p, q)))
    assert len(tiles) == 6
    for k, (t, r) in enumerate(zip(tiles, ref_tiles)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert tuple(t.shape) == (len(p), got.tile_slots)
        np.testing.assert_array_equal(t.numpy(), np.asarray(r),
                                      err_msg=f"plane {k}")


@pytest.mark.parametrize("chunk", [8192, 64])
def test_segvis_grid_equals_reference_and_dense(walk_case, chunk):
    want, got, (ea, eb, ec), p, q = walk_case
    t = [torch.from_numpy(a) for a in (p, q, ea, eb, ec)]
    pruned = port_edgegrid.segvis_grid(*t, got, chunk=chunk).numpy()
    dense = ref.segvis_ref(*t).numpy()
    np.testing.assert_array_equal(pruned, dense)
    np.testing.assert_array_equal(pruned, np.asarray(ref_edgegrid.segvis_grid(
        *map(jnp.asarray, (p, q, ea, eb, ec)), want)))
    kernel_path = port_edgegrid.segvis_grid(*t, got, use_kernels=True,
                                            chunk=chunk).numpy()
    np.testing.assert_array_equal(kernel_path, dense)
    assert 0 < pruned.sum() < len(p)


# ---------------------------------------------------------------------------
# the slice as a whole: engines over a forced-grid artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_index():
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def grid_bx(port_index):
    bx = port_packed.pack_bucketed(port_index, edge_grid=True, device="cpu")
    assert bx.grid is not None
    return bx


@pytest.fixture(scope="module")
def dense_bx(port_index):
    bx = port_packed.pack_bucketed(port_index, edge_grid=False, device="cpu")
    assert bx.grid is None
    return bx


@pytest.fixture(scope="module")
def queries(scene_s, graph_s):
    from repro.core.workload import uniform_queries
    qs = uniform_queries(scene_s, graph_s, 160, seed=23)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.fixture(scope="module")
def reference_grid_answers(compressed_s, queries):
    bx = ref_packed.pack_bucketed(compressed_s[0], edge_grid=True)
    assert bx.grid is not None
    return tuple(np.asarray(a) for a in ref_packed.query_batch_bucketed(
        bx, *queries, want_argmin=True))


@pytest.mark.parametrize("engine_cls", [TorchEngine, CudaEngine])
def test_grid_engine_matches_reference(grid_bx, queries,
                                       reference_grid_answers, engine_cls):
    got = PathServer(engine_cls(grid_bx), batch_size=64)._dispatch(
        *queries, want_argmin=True)
    want = reference_grid_answers
    assert [a.dtype for a in got] == [a.dtype for a in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for name, g, w in list(zip(ANSWERS, got, want))[1:]:
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_grid_answers_equal_dense_answers(grid_bx, dense_bx, queries,
                                          use_kernels):
    """§10 identity inside the port: every output bit for bit."""
    got = port_packed.query_batch_bucketed(grid_bx, *queries,
                                           use_kernels=use_kernels,
                                           want_argmin=True)
    want = port_packed.query_batch_bucketed(dense_bx, *queries,
                                            use_kernels=use_kernels,
                                            want_argmin=True)
    for name, g, w in zip(ANSWERS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_grid_engine_runs_tiles_not_dense(grid_bx, queries):
    """On a grid artifact the visibility fold and covis go through
    segvis_tiles only: the dense predicate is never evaluated."""
    dense, tiles = ref.segvis_ref.calls, ref.segvis_tiles_ref.calls
    PathServer(CudaEngine(grid_bx), batch_size=64).query(*queries)
    assert ref.segvis_ref.calls == dense
    assert ref.segvis_tiles_ref.calls > tiles


def test_grid_path_server_matches_float64_truth(grid_bx, port_index,
                                                compressed_s, queries_s):
    _, truth = compressed_s
    srv = PathServer(CudaEngine(grid_bx), batch_size=32)
    srv.warmup(paths=True)
    d = srv.query(queries_s.s, queries_s.t)
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(truth))
    fin = np.isfinite(truth)
    np.testing.assert_allclose(d[fin], truth[fin], rtol=HOST_TOL,
                               atol=HOST_TOL)
    dp, paths = srv.query_paths(queries_s.s[:16], queries_s.t[:16],
                                host_index=port_index)
    np.testing.assert_array_equal(dp, d[:16])
    for di, p in zip(dp, paths):
        if np.isfinite(di):
            assert abs(path_length(p) - di) <= HOST_TOL * max(1.0, di)
