"""Port host index and bucketed packer vs the JAX reference (rooms-S, 0.2).

The port builds its own host index with its own copies of the numpy index
code; it must land on the reference's region partition and label packs,
and its ``pack_bucketed(device="cpu")`` planes must equal the reference's
``pack_bucketed(edge_grid=False)`` (the auto policy would attach an edge
grid on rooms-S, which this slice does not port yet).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import packed as ref_packed
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.visgraph import build_visgraph

SLABS = ("hub_ids", "via_xy", "via_d", "via_ids")
PLANES = ("mapper", "region_bucket", "region_row",
          "edges_a", "edges_b", "edges_c")
STATIC = ("nx", "ny", "cell_size", "width", "height", "widths")


@pytest.fixture(scope="module")
def port_index():
    """The port's own rooms-S (seed 1) index, compressed to 0.2."""
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def ref_bucketed(compressed_s):
    return ref_packed.pack_bucketed(compressed_s[0], edge_grid=False)


def reference_planes(bx) -> dict:
    """A reference BucketedIndex's fields as numpy (lists per bucket)."""
    planes = {k: [np.asarray(a) for a in getattr(bx, k)] for k in SLABS}
    planes.update({k: np.asarray(getattr(bx, k)) for k in PLANES})
    planes.update({k: getattr(bx, k) for k in STATIC})
    planes["grid"] = bx.grid
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


def test_bucketed_from_numpy_equals_port_pack(port_index, ref_bucketed):
    carried = port_packed.bucketed_from_numpy(reference_planes(ref_bucketed),
                                              device="cpu")
    own = port_packed.pack_bucketed(port_index, device="cpu")
    planes = {k: [a.numpy() for a in getattr(own, k)] for k in SLABS}
    planes.update({k: getattr(own, k).numpy() for k in PLANES})
    planes.update({k: getattr(own, k) for k in STATIC})
    assert_same_artifact(carried, planes)


def test_bucketed_from_numpy_refuses_edge_grid(compressed_s):
    gridded = ref_packed.pack_bucketed(compressed_s[0], edge_grid=True)
    with pytest.raises(ValueError, match="dense"):
        port_packed.bucketed_from_numpy(reference_planes(gridded), "cpu")


def test_bucketed_from_numpy_refuses_quantized_slabs(compressed_s):
    quant = ref_packed.pack_bucketed(compressed_s[0], edge_grid=False,
                                     layout=ref_packed.slab_layout("bf16"))
    with pytest.raises(ValueError, match="slab per bucket|float32 layout"):
        port_packed.bucketed_from_numpy(reference_planes(quant), "cpu")


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
