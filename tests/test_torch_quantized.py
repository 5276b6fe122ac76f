"""Port quantized slabs (DESIGN.md §11) vs the JAX reference (rooms-S, CPU).

The join twin must widen bf16/f16 distances to float32 before it sums, as
the reference and the TPU kernel's wrapper do.  The port's host encoders
must produce the reference's slabs byte for byte (bf16 compared as its
uint16 bits); its device-byte estimator, quantization record and residual
rows must equal the reference's; decoded ids and via coordinates must equal
the f32 planes exactly.  Served answers: distances within rtol 1e-6 of the
reference's quantized path, argmin winners after the residual rescue equal
to the port's own f32 engine bit for bit and to the reference's except at
its ties, the ambiguity flag equal to the reference's.  The device-budget
merge loop must take both packages through the same merges.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import packed as ref_packed
from repro.core.compression import \
    compress_to_device_budget as ref_compress_to_device_budget
from repro.core.grid import build_ehl as ref_build_ehl
from repro.kernels import ref as jref
from repro.kernels.label_join import label_join_rowmin as pallas_rowmin
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import (compress_to_device_budget,
                                          compress_to_fraction)
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.visgraph import build_visgraph
from repro_torch.kernels import ops, ref
from repro_torch.serving import (CudaEngine, PathServer, TorchEngine,
                                 make_engine)

from test_torch_packed import PLANES, STATIC, reference_planes
from test_torch_serving import tied_rows

LAYOUTS = ("bf16", "f16")
NARROW = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
QSLABS = ("hub_ids", "via_d", "via_ids", "hub_base", "vid_base")
# rows whose port ambiguity flag may differ from the reference's: those
# with a join margin within 1e-6 (relative) of the threshold, where one ulp
# of the via-distance norm decides.  On these inputs there are none.
AMB_NEAR_THRESHOLD_ROWS = {"bf16": [], "f16": []}


def bits(x) -> np.ndarray:
    """A plane as numpy with 2-byte ids and bf16 as their uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.int16, torch.bfloat16):
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x


def quant_planes(bx) -> dict:
    """A reference quantized BucketedIndex as the planes
    ``bucketed_from_numpy`` takes (with its residual rows)."""
    planes = reference_planes(bx)
    planes.update({k: [np.asarray(a) for a in getattr(bx, k)]
                   for k in ("hub_base", "vid_base")})
    planes.update(vert_xy=np.asarray(bx.vert_xy),
                  qerr=float(np.asarray(bx.qerr)), layout=bx.layout,
                  residual_d=[np.asarray(a) for a in bx.residual.d])
    return planes


@pytest.fixture(scope="module")
def port_index():
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def port_bx(port_index):
    return {name: port_packed.pack_bucketed(
        port_index, layout=port_packed.slab_layout(name), device="cpu")
        for name in ("f32",) + LAYOUTS}


@pytest.fixture(scope="module")
def ref_bx(compressed_s):
    return {name: ref_packed.pack_bucketed(
        compressed_s[0], layout=ref_packed.slab_layout(name))
        for name in ("f32",) + LAYOUTS}


@pytest.fixture(scope="module")
def queries(scene_s, graph_s):
    from repro.core.workload import uniform_queries
    qs = uniform_queries(scene_s, graph_s, 160, seed=23)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


# ---------------------------------------------------------------------------
# the narrow-distance fault of the join twin
# ---------------------------------------------------------------------------

def _join_rows(rng, b, l):
    hs = np.sort(rng.integers(0, 24, (b, l)), axis=1).astype(np.int32)
    ht = np.sort(rng.integers(0, 24, (b, l)), axis=1).astype(np.int32)
    vs = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vt = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vs[rng.random((b, l)) < 0.2] = np.inf
    vt[rng.random((b, l)) < 0.2] = np.inf
    return hs, vs, ht, vt


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b,l", [(4, 128), (9, 256)])
def test_rowmin_twin_widens_narrow_distances(layout, b, l):
    """bf16/f16 ``vd``: the twin's [B, L] is float32 and equals the
    reference's, which widens to float32 before it sums (and the Pallas
    kernel's entry point, run in interpret mode)."""
    tdt, jdt = NARROW[layout]
    hs, vs, ht, vt = _join_rows(np.random.default_rng(b * 31 + l), b, l)
    port = ref.label_join_rowmin_ref(
        torch.from_numpy(hs), torch.from_numpy(vs).to(tdt),
        torch.from_numpy(ht), torch.from_numpy(vt).to(tdt))
    j = (jnp.asarray(hs), jnp.asarray(vs).astype(jdt), jnp.asarray(ht),
         jnp.asarray(vt).astype(jdt))
    want = np.asarray(jref.label_join_rowmin_ref(*j))
    assert want.dtype == np.float32
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), want)
    np.testing.assert_array_equal(port.numpy(),
                                  np.asarray(pallas_rowmin(*j,
                                                           interpret=True)))
    cpu = ops.label_join_rowmin_kernel(
        torch.from_numpy(hs), torch.from_numpy(vs).to(tdt),
        torch.from_numpy(ht), torch.from_numpy(vt).to(tdt))
    assert torch.equal(cpu, port)


# ---------------------------------------------------------------------------
# host encoders
# ---------------------------------------------------------------------------

def test_delta_u16_roundtrip_with_pads():
    ids = np.array([[7, 100, -1, 65541], [0, 0, -1, -1]], np.int32)
    valid = ids >= 0
    enc, base = port_packed.encode_delta_u16(ids, valid)
    assert enc.dtype == np.uint16 and base.dtype == np.int32
    assert (enc[~valid] == 0xFFFF).all()          # pad sentinel
    dec = base[:, None].astype(np.int64) + enc
    np.testing.assert_array_equal(dec[valid], ids[valid])
    want = ref_packed.encode_delta_u16(ids, valid)
    np.testing.assert_array_equal(enc, want[0])
    np.testing.assert_array_equal(base, want[1])
    # the device decode of the stored bits gives the ids back, pads as -1
    dec = port_packed._decode_ids(port_packed._u16_tensor(enc),
                                  torch.from_numpy(base), -1)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), np.where(valid, ids, -1))


def test_delta_u16_range_overflow_returns_none():
    ids = np.array([[5, 70005]], np.int64)
    enc, base = port_packed.encode_delta_u16(ids, np.ones_like(ids, bool))
    assert enc is None and base is None
    ids = np.array([[1_000_000, 1_000_002]], np.int64)
    enc, base = port_packed.encode_delta_u16(ids, np.ones_like(ids, bool))
    assert enc is not None and int(base[0]) == 1_000_000


def test_quantize_slab_id_fallback_is_loud():
    lay = port_packed.slab_layout("bf16")
    R, W = 2, 4
    xy = np.zeros((R, W, 2), np.float32)
    d = np.full((R, W), 1.5, np.float32)
    wide_hub = np.array([[0, 80_000, -1, -1]] * R, np.int32)   # range > u16
    vid = np.tile(np.arange(W, dtype=np.int32), (R, 1))        # range ok
    hub_q, d_q, vid_q, hub_base, vid_base, qerr = port_packed._quantize_slab(
        (wide_hub, xy, d, vid), lay)
    assert hub_q.dtype == torch.int32           # fell back, ids untouched
    np.testing.assert_array_equal(hub_q.numpy(), wide_hub)
    assert vid_q.dtype == port_packed.U16_STORAGE   # independent planes
    assert d_q.dtype == torch.bfloat16
    st = port_packed._quant_stats(lay, [hub_q, vid_q], [d_q], [vid_q], qerr)
    assert st["id_fallback"] == (True, False)
    assert st["dist_fallback"] == (False,)
    want = ref_packed._quantize_slab((wide_hub, xy, d, vid),
                                     ref_packed.slab_layout("bf16"))
    for got, w in zip((hub_q, d_q, vid_q, hub_base, vid_base), want):
        np.testing.assert_array_equal(bits(got), bits(w))
    assert qerr == want[5]


def test_encode_dist_f16_finite_overflow_falls_back():
    d = np.array([1.0, 70_000.0, np.inf], np.float32)   # f16 max is 65504
    dq, qerr = port_packed.encode_dist(d, torch.float16)
    assert dq is None and qerr == 0.0
    dq, qerr = port_packed.encode_dist(d, torch.bfloat16)
    assert dq is not None
    back = dq.to(torch.float32).numpy()
    assert np.isinf(back[2]) and np.isfinite(back[:2]).all()
    assert np.abs(back[:2] - d[:2]).max() <= qerr


def test_encode_dist_bf16_finite_overflow_falls_back():
    d = np.array([np.float32(3.4e38)], np.float32)
    dq, qerr = port_packed.encode_dist(d, torch.bfloat16)
    assert dq is None and qerr == 0.0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_encode_dist_subnormals_stay_in_bound(layout):
    tdt = NARROW[layout][0]
    d = np.array([1e-5, 6.1e-5, 5e-4, 1e-40, 0.0, np.inf], np.float32)
    dq, qerr = port_packed.encode_dist(d, tdt)
    assert dq is not None
    back = dq.to(torch.float32).numpy()
    fin = np.isfinite(d)
    assert np.array_equal(fin, np.isfinite(back))
    assert np.abs(back[fin] - d[fin]).max() <= qerr
    assert float(back[4]) == 0.0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_encode_dist_bits_equal_reference(layout):
    """Round to nearest even, subnormals, halfway cases and +inf: the port's
    narrow bits and qerr equal the reference's (ml_dtypes / numpy)."""
    rng = np.random.default_rng(5)
    d = np.concatenate([
        rng.uniform(0, 200, 4000), rng.uniform(0, 1e-3, 500),
        np.float32([1e-40, 6.1e-5, 0.0, 1.0, 1.00390625, 1.01171875,
                    65504.0, 65504.5, 60000.25, np.inf])]).astype(np.float32)
    dq, qerr = port_packed.encode_dist(d, NARROW[layout][0])
    want, want_err = ref_packed.encode_dist(
        d, ref_packed.slab_layout(layout).dist_dtype)
    np.testing.assert_array_equal(bits(dq), bits(want))
    assert qerr == want_err


# ---------------------------------------------------------------------------
# slabs, bytes, quantization record, residual rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_quantized_slabs_equal_reference(layout, port_bx, ref_bx):
    got, want = port_bx[layout], ref_bx[layout]
    assert got.via_xy == () and len(want.via_xy) == 0
    for k in QSLABS:
        assert len(getattr(got, k)) == len(getattr(want, k)), k
        for a, b in zip(getattr(got, k), getattr(want, k)):
            assert bits(a).dtype == bits(b).dtype, k
            np.testing.assert_array_equal(bits(a), bits(b), err_msg=k)
    for k in PLANES:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    for k in STATIC:
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.vert_xy.numpy(),
                                  np.asarray(want.vert_xy))
    assert got.qerr.dtype == torch.float32
    assert float(got.qerr) == float(np.asarray(want.qerr)) > 0.0
    assert got.device_bytes() == want.device_bytes()
    assert got.bucket_stats() == want.bucket_stats()
    gs, ws = got.quant_stats(), want.quant_stats()
    assert (gs["layout"].dist, gs["layout"].ids) == \
        (ws["layout"].dist, ws["layout"].ids)
    for k in ("qerr", "id_fallback", "vid_fallback", "dist_fallback"):
        assert gs[k] == ws[k], k


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residual_rows_equal_reference(layout, port_bx, ref_bx):
    got, want = port_bx[layout].residual, ref_bx[layout].residual
    regions = np.arange(len(got.region_bucket))
    for w in got.widths:
        np.testing.assert_array_equal(got.gather_d(regions, w),
                                      want.gather_d(regions, w))
    pts = np.random.default_rng(2).uniform(
        0, [port_bx[layout].width, port_bx[layout].height], (64, 2))
    np.testing.assert_array_equal(got.locate(pts), want.locate(pts))


@pytest.mark.parametrize("edge_grid", [None, True, False],
                         ids=["auto", "grid", "dense"])
@pytest.mark.parametrize("layout", ("f32",) + LAYOUTS)
def test_device_byte_estimator_equals_reference(layout, edge_grid,
                                                port_index, compressed_s):
    """``bucketed_device_bytes`` equals the realized ``device_bytes()`` of
    the port's pack and both of the reference's, under every layout and
    grid policy."""
    est = port_packed.bucketed_device_bytes(
        port_index, edge_grid=edge_grid,
        layout=port_packed.slab_layout(layout))
    assert est == ref_packed.bucketed_device_bytes(
        compressed_s[0], edge_grid=edge_grid,
        layout=ref_packed.slab_layout(layout))
    bx = port_packed.pack_bucketed(port_index, edge_grid=edge_grid,
                                   layout=port_packed.slab_layout(layout),
                                   device="cpu")
    assert bx.device_bytes() == est
    assert port_packed.dtype_bytes(port_packed.slab_layout(layout)) \
        .__dict__ == ref_packed.dtype_bytes(
            ref_packed.slab_layout(layout)).__dict__


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decoded_planes_equal_f32_planes(layout, port_bx):
    """Hub ids, via ids and via coordinates decode to the f32 planes
    exactly at every dispatch bucket; distances come back within qerr."""
    f32, q = port_bx["f32"], port_bx[layout]
    qerr = float(q.qerr)
    regions = torch.arange(f32.region_bucket.shape[0], dtype=torch.int32)
    for k in range(f32.num_buckets):
        want = port_packed._gather_bucketed(f32, regions, k)
        got = port_packed._gather_bucketed(q, regions, k)
        for name, a, b in zip(("hub", "xy", "vd", "vid"), got, want):
            assert a.dtype == b.dtype, name
            if name == "vd":
                fin = torch.isfinite(b)
                assert torch.equal(fin, torch.isfinite(a))
                assert float((a[fin] - b[fin]).abs().max()) <= qerr
            else:
                assert torch.equal(a, b), name
    # a wider gather pads with inert slots
    W = f32.widths[-1] * 2
    a = port_packed._gather_bucketed(q, regions, f32.num_buckets - 1, W)
    b = port_packed._gather_bucketed(f32, regions, f32.num_buckets - 1, W)
    assert a[0].shape == (len(regions), W)
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])


# ---------------------------------------------------------------------------
# the ambiguity flag
# ---------------------------------------------------------------------------

def test_join_masked_flags_margin_ties():
    qerr2 = torch.tensor(0.5)     # summed per-side bound; threshold 2*qerr2
    PAD_HUB = 9                   # never matches across sides (vd is inf)
    hub = torch.tensor([
        [0, 1, PAD_HUB, PAD_HUB],   # two candidates, margin == 2*qerr2
        [0, 1, PAD_HUB, PAD_HUB],   # two candidates, margin >> threshold
        [0, PAD_HUB, PAD_HUB, PAD_HUB],   # unique candidate
    ], dtype=torch.int32)
    inf = float("inf")
    vd_s = torch.tensor([[10.0, 11.0, inf, inf], [10.0, 12.0, inf, inf],
                         [10.0, inf, inf, inf]])
    vd_t = torch.where(torch.isfinite(vd_s), 0.0, inf)
    vid_s = torch.arange(12, dtype=torch.int32).reshape(3, 4) + 100
    vid_t = vid_s + 50
    s = torch.zeros((3, 2))
    t = torch.ones((3, 2))
    covis = torch.zeros(3, dtype=torch.bool)

    d, cv, via_s, hub_w, via_t, amb = port_packed.join_masked(
        (hub, vd_s, vid_s), (hub, vd_t, vid_t), s, t, covis,
        want_argmin=True, qerr2=qerr2)
    np.testing.assert_allclose(d.numpy(), [10.0, 10.0, 10.0])
    np.testing.assert_array_equal(via_s.numpy(), [100, 104, 108])
    np.testing.assert_array_equal(hub_w.numpy(), [0, 0, 0])
    np.testing.assert_array_equal(via_t.numpy(), [150, 154, 158])
    # inclusive: a tie exactly at 2*qerr2 must be rescued
    np.testing.assert_array_equal(amb.numpy(), [True, False, False])
    res = port_packed.join_masked((hub, vd_s, vid_s), (hub, vd_t, vid_t),
                                  s, t, covis, want_argmin=True)
    assert len(res) == 5


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ambiguity_flag_equals_reference(layout, port_bx, ref_bx, queries):
    """Per dispatch bucket, the port's ``amb`` equals the reference's,
    except rows whose margin lies within 1e-6 (relative) of the threshold:
    those are named in AMB_NEAR_THRESHOLD_ROWS."""
    bx = port_bx[layout]
    s, t = queries
    buckets = port_packed.dispatch_buckets(bx, s, t)
    differ, flagged = [], 0
    for k in np.unique(buckets):
        rows = np.nonzero(buckets == k)[0]
        got = port_packed.query_batch_at_bucket(
            bx, s[rows], t[rows], bucket=int(k), want_argmin=True)
        want = ref_packed.query_batch_at_bucket(
            ref_bx[layout], jnp.asarray(s[rows]), jnp.asarray(t[rows]),
            bucket=int(k), want_argmin=True)
        assert len(got) == 6
        a, b = got[5].numpy(), np.asarray(want[5])
        flagged += int(a.sum())
        differ += [int(r) for r in rows[a != b]]
    assert flagged > 0
    assert sorted(differ) == AMB_NEAR_THRESHOLD_ROWS[layout]


# ---------------------------------------------------------------------------
# answers and argmin winners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_quantized_answers_match_reference_and_f32(layout, use_kernels,
                                                   port_bx, ref_bx, queries):
    """Distances within rtol 1e-6 of the reference's quantized path; winners
    after the rescue equal the port's f32 answers bit for bit and the
    reference's except at its ties; distances within 2*qerr of f32."""
    s, t = queries
    got = port_packed.query_batch_bucketed(port_bx[layout], s, t,
                                           use_kernels=use_kernels,
                                           want_argmin=True)
    want = [np.asarray(a) for a in ref_packed.query_batch_bucketed(
        ref_bx[layout], s, t, want_argmin=True)]
    f32 = port_packed.query_batch_bucketed(port_bx["f32"], s, t,
                                           use_kernels=use_kernels,
                                           want_argmin=True)
    assert [a.dtype for a in got] == [a.dtype for a in want]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    tied = tied_rows(port_bx["f32"], s, t)
    ids_differ = ((got[2] != want[2]) | (got[3] != want[3])
                  | (got[4] != want[4]))
    assert not (ids_differ & ~tied).any(), np.nonzero(ids_differ & ~tied)
    for a, b in zip(got[1:], f32[1:]):
        np.testing.assert_array_equal(a, b)
    qerr = float(port_bx[layout].qerr)
    fin = np.isfinite(f32[0])
    assert np.array_equal(fin, np.isfinite(got[0]))
    assert np.all(np.abs(got[0][fin] - f32[0][fin])
                  <= 2 * qerr + 1e-6 * np.abs(f32[0][fin]))
    d = port_packed.query_batch_bucketed(port_bx[layout], s, t,
                                         use_kernels=use_kernels)
    np.testing.assert_allclose(d, got[0], rtol=0, atol=2 * qerr)


@pytest.mark.parametrize("engine_cls", [TorchEngine, CudaEngine])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_quantized_engine_winners_equal_f32_engine(layout, engine_cls,
                                                   port_bx, queries):
    """Through PathServer (padded batches of 64): the quantized engine's
    argmin outputs after the rescue equal the f32 engine's bit for bit on
    covis and the winners, rescues happen and are counted, and the two
    device engines agree on all five outputs."""
    s, t = queries
    eng = engine_cls(port_bx[layout])
    assert eng.quantized
    srv = PathServer(eng, batch_size=64)
    srv.warmup(paths=True)
    eng.rescue_batches = eng.rescue_rows = 0
    got = srv._dispatch(s, t, want_argmin=True)
    want = PathServer(engine_cls(port_bx["f32"]), batch_size=64)._dispatch(
        s, t, want_argmin=True)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert eng.rescue_batches > 0 and eng.rescue_rows >= eng.rescue_batches
    other = (CudaEngine if engine_cls is TorchEngine else TorchEngine)
    twin = PathServer(other(port_bx[layout]), batch_size=64)._dispatch(
        s, t, want_argmin=True)
    for a, b in zip(got, twin):
        np.testing.assert_array_equal(a, b)


def test_make_engine_packs_quantized(port_index, port_bx):
    eng = make_engine(port_index, backend="torch", device="cpu",
                      layout=port_packed.slab_layout("bf16"))
    assert eng.quantized and eng.index.layout.dist == "bf16"
    assert eng.index.device_bytes() == port_bx["bf16"].device_bytes()
    assert not make_engine(port_index, backend="torch",
                           device="cpu").quantized


# ---------------------------------------------------------------------------
# the reference's own artifact through bucketed_from_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_reference_quantized_artifact_through_port(layout, port_bx, ref_bx,
                                                   queries):
    carried = port_packed.bucketed_from_numpy(quant_planes(ref_bx[layout]),
                                              "cpu")
    own = port_bx[layout]
    assert carried.layout == own.layout
    for k in QSLABS:
        for a, b in zip(getattr(carried, k), getattr(own, k)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(carried.vert_xy, own.vert_xy)
    assert float(carried.qerr) == float(own.qerr)
    assert carried.device_bytes() == own.device_bytes()
    s, t = queries
    for a, b in zip(
            port_packed.query_batch_bucketed(carried, s, t, want_argmin=True),
            port_packed.query_batch_bucketed(own, s, t, want_argmin=True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", ["missing", "via_xy", "dtype", "base",
                                   "residual"])
def test_bucketed_from_numpy_refuses_malformed_quantized(fault, ref_bx):
    planes = quant_planes(ref_bx["bf16"])
    if fault == "missing":
        del planes["vert_xy"]
    elif fault == "via_xy":
        planes["via_xy"] = [np.zeros((1, 128, 2), np.float32)] * 2
    elif fault == "dtype":
        planes["via_d"] = [a.astype(np.float16) for a in planes["via_d"]]
    elif fault == "base":
        planes["hub_base"] = [a[:-1] for a in planes["hub_base"]]
    else:
        planes["residual_d"] = planes["residual_d"][:1]
    with pytest.raises(ValueError):
        port_packed.bucketed_from_numpy(planes, "cpu")


def test_rescue_needs_the_residual(ref_bx, queries):
    planes = quant_planes(ref_bx["bf16"])
    del planes["residual_d"]
    bx = port_packed.bucketed_from_numpy(planes, "cpu")
    s, t = queries
    with pytest.raises(ValueError, match="ResidualTable"):
        port_packed.rescue_exact(bx, s[:4], t[:4], bx.widths[-1],
                                 torch.zeros(4, dtype=torch.bool))


# ---------------------------------------------------------------------------
# device-budgeted compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_compress_to_device_budget_equals_reference(layout, scene_s, graph_s,
                                                    hl_s, ref_bx):
    """Fresh copies of one index, one budget (0.6x the f32 artifact of the
    0.2-compressed index): both packages make the same merges, land on the
    same regions and the same device bytes, and the port's packed artifact
    realizes them."""
    budget = int(0.6 * ref_bx["f32"].device_bytes())
    ref_idx = ref_build_ehl(scene_s, cell_size=2.0, graph=graph_s, hl=hl_s)
    port_scene = make_map("rooms-S", seed=1)
    port_idx = build_ehl(port_scene, cell_size=2.0,
                         graph=build_visgraph(port_scene))
    want = ref_compress_to_device_budget(
        ref_idx, budget, layout=ref_packed.slab_layout(layout))
    got = compress_to_device_budget(
        port_idx, budget, layout=port_packed.slab_layout(layout))
    assert got.__dict__ == want.__dict__
    assert got.device_bytes <= budget
    np.testing.assert_array_equal(port_idx.mapper, ref_idx.mapper)
    assert sorted(port_idx.regions) == sorted(ref_idx.regions)
    bx = port_packed.pack_bucketed(port_idx,
                                   layout=port_packed.slab_layout(layout),
                                   device="cpu")
    assert bx.device_bytes() == got.device_bytes
