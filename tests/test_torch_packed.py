"""Port host index and bucketed packer vs the JAX reference (rooms-S, 0.2).

The port builds its own host index with its own copies of the numpy index
code; it must land on the reference's region partition and label packs,
and its ``pack_bucketed(edge_grid=..., device="cpu")`` planes, edge-grid
planes and ``device_bytes()`` must equal the reference's
``pack_bucketed(edge_grid=...)`` under each policy: auto (``None``), forced
on and forced off.  On rooms-S seed 1 the auto policy stays dense; on
rooms-S seed 0 it attaches the grid.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import packed as ref_packed
from repro.core.compression import compress_to_fraction as ref_compress
from repro.core.grid import build_ehl as ref_build_ehl
from repro.core.maps import make_map as ref_make_map
from repro.core.visgraph import build_visgraph as ref_build_visgraph
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.visgraph import build_visgraph

SLABS = ("hub_ids", "via_xy", "via_d", "via_ids")
PLANES = ("mapper", "region_bucket", "region_row",
          "edges_a", "edges_b", "edges_c")
STATIC = ("nx", "ny", "cell_size", "width", "height", "widths")
GRID_STATIC = ("gnx", "gny", "gcell", "sentinel", "eps")


@pytest.fixture(scope="module")
def port_index():
    """The port's own rooms-S (seed 1) index, compressed to 0.2."""
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def port_index_seed0():
    """The port's rooms-S seed 0 index at 0.2: the auto policy attaches."""
    scene = make_map("rooms-S", seed=0)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def ref_index_seed0():
    scene = ref_make_map("rooms-S", seed=0)
    idx = ref_build_ehl(scene, cell_size=2.0,
                        graph=ref_build_visgraph(scene))
    ref_compress(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def ref_bucketed(compressed_s):
    return ref_packed.pack_bucketed(compressed_s[0], edge_grid=False)


def grid_planes(grid) -> dict | None:
    """An edge grid's planes as numpy and its static fields (None: none)."""
    if grid is None:
        return None
    planes = {k: np.asarray(getattr(grid, k)) for k in ("cell_ids",
                                                         "cell_len")}
    planes.update({k: getattr(grid, k) for k in GRID_STATIC})
    return planes


def reference_planes(bx) -> dict:
    """A reference BucketedIndex's fields as numpy (lists per bucket)."""
    planes = {k: [np.asarray(a) for a in getattr(bx, k)] for k in SLABS}
    planes.update({k: np.asarray(getattr(bx, k)) for k in PLANES})
    planes.update({k: getattr(bx, k) for k in STATIC})
    planes["grid"] = grid_planes(bx.grid)
    return planes


def port_planes(bx) -> dict:
    """The port's BucketedIndex fields in the same numpy form."""
    planes = {k: [a.numpy() for a in getattr(bx, k)] for k in SLABS}
    planes.update({k: getattr(bx, k).numpy() for k in PLANES})
    planes.update({k: getattr(bx, k) for k in STATIC})
    planes["grid"] = grid_planes(bx.grid)
    return planes


def assert_same_artifact(port, planes):
    for k in SLABS:
        assert len(getattr(port, k)) == len(planes[k]), k
        for got, want in zip(getattr(port, k), planes[k]):
            assert got.numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for k in PLANES:
        got = getattr(port, k).numpy()
        assert got.dtype == planes[k].dtype, k
        np.testing.assert_array_equal(got, planes[k], err_msg=k)
    for k in STATIC:
        assert getattr(port, k) == planes[k], k
    want = planes.get("grid")
    assert (port.grid is None) == (want is None)
    if want is not None:
        got = grid_planes(port.grid)
        for k in ("cell_ids", "cell_len"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in GRID_STATIC:
            assert got[k] == want[k], k


def test_host_index_same_partition(port_index, compressed_s):
    ref = compressed_s[0]
    np.testing.assert_array_equal(port_index.mapper, ref.mapper)
    assert sorted(port_index.regions) == sorted(ref.regions)
    for rid, r in ref.regions.items():
        p = port_index.regions[rid]
        np.testing.assert_array_equal(p.keys, r.keys)
        np.testing.assert_array_equal(p.hubs, r.hubs)
        assert sorted(p.cells) == sorted(r.cells)


def test_host_index_same_region_packs(port_index, compressed_s):
    ref = compressed_s[0]
    for rid in sorted(ref.regions):
        want = ref.pack_region(ref.regions[rid])
        got = port_index.pack_region(port_index.regions[rid])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_bucketed_planes_equal_reference(port_index, ref_bucketed):
    port = port_packed.pack_bucketed(port_index, device="cpu")
    assert_same_artifact(port, reference_planes(ref_bucketed))
    assert port.device_bytes() == ref_bucketed.device_bytes()
    assert port.bucket_stats() == ref_bucketed.bucket_stats()


@pytest.mark.parametrize("edge_grid", [None, True, False],
                         ids=["auto", "grid", "dense"])
@pytest.mark.parametrize("seed", [1, 0])
def test_pack_bucketed_grid_policy_equals_reference(
        seed, edge_grid, port_index, port_index_seed0, compressed_s,
        ref_index_seed0):
    """Every plane, the grid's planes and ``device_bytes()`` under each
    policy; seed 1 stays dense under auto, seed 0 attaches the grid."""
    port_idx = port_index if seed == 1 else port_index_seed0
    ref_idx = compressed_s[0] if seed == 1 else ref_index_seed0
    want = ref_packed.pack_bucketed(ref_idx, edge_grid=edge_grid)
    got = port_packed.pack_bucketed(port_idx, edge_grid=edge_grid,
                                    device="cpu")
    assert_same_artifact(got, reference_planes(want))
    assert got.device_bytes() == want.device_bytes()
    if edge_grid is None:
        assert (got.grid is not None) == (seed == 0)


def test_default_pack_attaches_grid_on_rooms_s_seed0(port_index_seed0):
    """The default artifact of rooms-S seed 0 at 0.2 carries the grid."""
    bx = port_packed.pack_bucketed(port_index_seed0, device="cpu")
    g = bx.grid
    assert (g.gnx, g.gny, g.ell_width, g.tile_slots) == (8, 8, 4, 96)
    assert bx.widths == (128,) and bx.region_bucket.shape[0] == 153
    assert bx.device_bytes() == 400876
    dense = port_packed.pack_bucketed(port_index_seed0, edge_grid=False,
                                      device="cpu")
    assert bx.device_bytes() - dense.device_bytes() == g.device_bytes()


def test_bucketed_from_numpy_equals_port_pack(port_index, ref_bucketed):
    carried = port_packed.bucketed_from_numpy(reference_planes(ref_bucketed),
                                              device="cpu")
    own = port_packed.pack_bucketed(port_index, edge_grid=False, device="cpu")
    assert_same_artifact(carried, port_planes(own))


def test_bucketed_from_numpy_carries_edge_grid(port_index, compressed_s):
    """A reference grid artifact is carried grid and all, and the port's
    answers on it equal its answers on its own grid artifact."""
    gridded = ref_packed.pack_bucketed(compressed_s[0], edge_grid=True)
    carried = port_packed.bucketed_from_numpy(reference_planes(gridded),
                                              "cpu")
    own = port_packed.pack_bucketed(port_index, edge_grid=True, device="cpu")
    assert carried.grid is not None
    assert_same_artifact(carried, port_planes(own))
    assert carried.device_bytes() == gridded.device_bytes()
    rng = np.random.default_rng(9)
    s = rng.uniform(0, [own.width, own.height], (96, 2)).astype(np.float32)
    t = rng.uniform(0, [own.width, own.height], (96, 2)).astype(np.float32)
    for a, b in zip(
            port_packed.query_batch_bucketed(carried, s, t, want_argmin=True),
            port_packed.query_batch_bucketed(own, s, t, want_argmin=True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["missing", "dtype", "shape", "ids"])
def test_bucketed_from_numpy_refuses_malformed_grid(compressed_s, fault):
    planes = reference_planes(
        ref_packed.pack_bucketed(compressed_s[0], edge_grid=True))
    grid = planes["grid"]
    if fault == "missing":
        del grid["eps"]
    elif fault == "dtype":
        grid["cell_ids"] = grid["cell_ids"].astype(np.int64)
    elif fault == "shape":
        grid["cell_len"] = grid["cell_len"][:-1]
    else:
        grid["cell_ids"] = grid["cell_ids"] + len(planes["edges_a"])
    with pytest.raises(ValueError, match="grid"):
        port_packed.bucketed_from_numpy(planes, "cpu")


def test_bucketed_from_numpy_refuses_quantized_slabs(compressed_s):
    quant = ref_packed.pack_bucketed(compressed_s[0], edge_grid=False,
                                     layout=ref_packed.slab_layout("bf16"))
    with pytest.raises(ValueError, match="slab per bucket|float32 layout"):
        port_packed.bucketed_from_numpy(reference_planes(quant), "cpu")


def assert_hub_rows_sorted(hub: np.ndarray, what: str):
    """The join kernel's fast path: hubs nondecreasing along every row, and
    HUB_PAD only as the row's tail."""
    assert hub.ndim == 2 and hub.shape[1] > 0, what
    assert (np.diff(hub.astype(np.int64), axis=1) >= 0).all(), what
    pad = (hub == int(port_packed.HUB_PAD)).astype(np.int8)
    assert (np.diff(pad, axis=1) >= 0).all(), what


@pytest.mark.parametrize("seed", [1, 0])
def test_hub_rows_sorted_in_slabs_and_gathers(seed, port_index,
                                              port_index_seed0):
    """Every bucket slab of the rooms-S artifact, and the gathered label rows
    of every region at every dispatch bucket, have sorted hub rows with
    HUB_PAD only at the tail: each hub's t-labels form one run."""
    idx = port_index if seed == 1 else port_index_seed0
    bx = port_packed.pack_bucketed(idx, edge_grid=False, device="cpu")
    for k, hub in enumerate(bx.hub_ids):
        assert_hub_rows_sorted(hub.numpy(), f"slab {k}")
    regions = torch.arange(bx.region_bucket.shape[0], dtype=torch.int32)
    for k, w in enumerate(bx.widths):
        hub = port_packed._gather_bucketed(bx, regions, k)[0].numpy()
        assert hub.shape == (len(regions), w)
        assert_hub_rows_sorted(hub, f"gather at bucket {k}")
        # a region of a wider bucket comes back as padding only
        wider = bx.region_bucket.numpy() > k
        assert (hub[wider] == int(port_packed.HUB_PAD)).all()


def test_hub_rows_sorted_in_reference_planes(ref_bucketed, ref_index_seed0):
    """The JAX reference's slabs (its packer run on the CPU), carried across
    through ``bucketed_from_numpy``, are sorted the same way."""
    for ref_bx in (ref_bucketed, ref_packed.pack_bucketed(ref_index_seed0)):
        planes = reference_planes(ref_bx)
        for k, hub in enumerate(planes["hub_ids"]):
            assert_hub_rows_sorted(hub, f"reference slab {k}")
        carried = port_packed.bucketed_from_numpy(planes, "cpu")
        regions = torch.arange(carried.region_bucket.shape[0],
                               dtype=torch.int32)
        for k in range(carried.num_buckets):
            assert_hub_rows_sorted(
                port_packed._gather_bucketed(carried, regions, k)[0].numpy(),
                f"carried gather at bucket {k}")


@pytest.mark.parametrize("n,lane", [(0, 128), (1, 128), (127, 128),
                                    (128, 128), (129, 128), (600, 128),
                                    (5, 64)])
def test_widths_and_edge_padding_match_reference(n, lane):
    assert port_packed.bucket_width(n, lane) == \
        ref_packed.bucket_width(n, lane)
    assert port_packed.padded_edge_count(n, lane) == \
        ref_packed.padded_edge_count(n, lane)


def test_pack_edges_degenerate_padding(port_index):
    ea, eb, ec = port_packed._pack_edges(port_index, lane=128)
    E = port_index.scene.edges.shape[0]
    assert ea.shape[0] == port_packed.padded_edge_count(E) > E
    np.testing.assert_array_equal(ea[E:], eb[E:])
    np.testing.assert_array_equal(eb[E:], ec[E:])
