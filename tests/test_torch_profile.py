"""The port's attribution layer (``repro_torch.obs.profile``, DESIGN.md §13)
and the ``label_join`` kernel entry, on the CPU.

* Cold entries: with the capture installed before a cold ``warmup``,
  ``entry_cold_total{entry}`` grows as ``TRACES.count`` does and live
  traffic adds nothing; ``disable_profile`` stops the capture; a
  background thread's cold keys are never credited to a foreground call.
* ``kernel_cost`` against hand counts, and the capture's cost counters.
* The kernel build and load series against a fake nvcc.
* ``ops.label_join_kernel`` and ``label_join_hubdense_ref`` against the
  reference (the Pallas kernel in interpret mode, as the reference's own
  tests run it).

Card-only checks (the CUDA-event timing, the kernel's launch costs) live
in ``tests/test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.kernels import ops as ref_ops
from repro_torch import obs
from repro_torch.core import (build_ehl, build_visgraph, compress_to_fraction,
                              make_map, pack_bucketed, slab_layout,
                              uniform_queries)
from repro_torch.core import packed
from repro_torch.core.packed import TRACES
from repro_torch.kernels import ops
from repro_torch.serving import PathServer

from test_torch_kernels import FAKE_NVCC


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
def rooms_s():
    scene = make_map("rooms-S", seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=2.0, graph=graph)
    compress_to_fraction(idx, 0.2)
    qs = uniform_queries(scene, graph, 64, seed=4, require_path=False)
    return idx, qs.s.astype(np.float32), qs.t.astype(np.float32)


def _series(reg, name) -> dict:
    return {dict(m.labels).get("entry", dict(m.labels).get("kernel")):
            m.value for m in reg.series(name)}


def _grown(reg, name, before) -> dict:
    """{label: growth} of a series family since ``before`` (its
    :func:`_series`), rows that did not grow left out."""
    return {k: v - before.get(k, 0) for k, v in _series(reg, name).items()
            if v > before.get(k, 0)}


# ------------------------------------------------------------ cold entries

@pytest.mark.parametrize("layout,batch", [("f32", 23), ("bf16", 21)])
def test_cold_entries_follow_trace_counter(rooms_s, layout, batch):
    """A warmup at a batch size no other test uses meets cold keys; each
    entry's ``entry_cold_total`` grows, by as many keys in all as
    ``TRACES.count``,
    with wall seconds and output bytes beside it; live traffic adds 0."""
    idx, s, t = rooms_s
    reg = obs.MetricsRegistry()
    cap = obs.enable_profile(registry=reg)
    try:
        assert TRACES.profiler is cap and cap.counter is TRACES
        bx = pack_bucketed(idx, layout=slab_layout(layout), device="cpu")
        srv = PathServer(bx, batch_size=batch, backend="cuda", device="cpu",
                         telemetry=obs.Telemetry.off(registry=reg))
        count0 = TRACES.count
        cold_before = _series(obs.REGISTRY, "entry_cold_total")
        srv.warmup(paths=True)
        cold = _grown(obs.REGISTRY, "entry_cold_total", cold_before)
        assert cold and sum(cold.values()) == TRACES.count - count0
        assert set(cold) <= set(packed.SERVING_ENTRIES)
        assert {"fold_endpoint", "join_endpoints"} <= set(cold)
        if layout == "bf16":
            assert {"gather_masked_exact", "join_masked"} <= set(cold)
        secs = _series(reg, "entry_cold_seconds_total")
        assert set(secs) == set(cold) and all(v > 0 for v in secs.values())
        out_bytes = _series(reg, "entry_cold_output_bytes_total")
        assert all(v > 0 for v in out_bytes.values())
        summ = cap.summary()
        assert {e: v["cold"] for e, v in summ.items()} == cold
        # steady state: the same shapes meet nothing cold
        srv.query(s, t)
        srv.query_paths(s[:8], t[:8], host_index=idx)
        assert _grown(obs.REGISTRY, "entry_cold_total", cold_before) == cold
        # the CPU path takes no CUDA-event timing
        assert cap.drain() == 0 and cap.stream_ms() == {}
    finally:
        obs.disable_profile()
    assert TRACES.profiler is None


def test_trace_counter_records_cold_keys_in_its_registry():
    """A counter's cold keys land on the process-wide registry."""
    before = _series(obs.REGISTRY, "entry_cold_total")
    counter = packed.TraceCounter()
    counter.see("fold_endpoint", "cpu", 7)
    counter.see("fold_endpoint", "cpu", 7)
    counter.see("fold_endpoint", "cpu", 8)
    counter.see("join_masked", "cpu", 7)
    assert counter.count == 3 and counter.thread_count() == 3
    assert _grown(obs.REGISTRY, "entry_cold_total", before) == \
        {"fold_endpoint": 2, "join_masked": 1}


def test_disable_profile_stops_capture(rooms_s):
    idx, s, t = rooms_s
    reg = obs.MetricsRegistry()
    obs.enable_profile(registry=reg)
    assert obs.disable_profile() is not None
    assert TRACES.profiler is None and obs.disable_profile() is None
    bx = pack_bucketed(idx, device="cpu")
    srv = PathServer(bx, batch_size=19, backend="torch", device="cpu",
                     telemetry=obs.Telemetry.off(registry=reg))
    before = TRACES.count
    srv.warmup()                            # cold, but the capture is off
    assert TRACES.count > before
    assert not reg.series("entry_cold_total")
    assert not reg.series("entry_cold_seconds_total")


def test_background_thread_cold_keys_not_credited():
    """A cold key met on another thread leaves the calling thread's count
    alone, so a foreground entry call that spawns and joins such a thread
    is not attributed as cold."""
    before_global, before_local = TRACES.count, TRACES.thread_count()
    th = threading.Thread(
        target=lambda: TRACES.see("elsewhere", object()))
    th.start()
    th.join()
    assert TRACES.count == before_global + 1
    assert TRACES.thread_count() == before_local

    @packed._serving_entry("join_masked")
    def warm_entry():
        bg = threading.Thread(
            target=lambda: TRACES.see("join_masked", object()))
        bg.start()
        bg.join()
        return torch.zeros(3)

    reg = obs.MetricsRegistry()
    with obs.profiled(registry=reg) as cap:
        warm_entry()
        assert cap.records == []
    assert not reg.series("entry_cold_seconds_total")
    assert TRACES.profiler is None


def test_serving_entries_are_named_and_wrapped():
    names = {fn.entry for fn in vars(packed).values()
             if callable(fn) and hasattr(fn, "entry")}
    assert names == set(packed.SERVING_ENTRIES)
    assert len(packed.SERVING_ENTRIES) == 10


# ------------------------------------------------------------ kernel costs

@pytest.mark.parametrize("name,shape,dist_bytes,ops_,bytes_", [
    # segvis: N*E pairs x 34; p, q (8 B a point), 3 edge planes, bool out
    ("segvis", (256, 128), 4, 256 * 128 * 34, 256 * 16 + 128 * 24 + 256),
    ("segvis", (131072, 128), 4, 131072 * 128 * 34,
     131072 * 16 + 128 * 24 + 131072),
    # segvis_tiles: N*S slots x 36 operations, 24 bytes a slot
    ("segvis_tiles", (8192, 192), 4, 8192 * 192 * 36,
     8192 * 192 * 24 + 8192 * 16 + 8192),
    ("segvis_tiles", (256, 96), 4, 256 * 96 * 36,
     256 * 96 * 24 + 256 * 16 + 256),
    # label_join_rowmin: 20*B*L bytes (16*B*L at 2-byte distances)
    ("label_join_rowmin", (256, 512), 4, 2 * 256 * 512, 20 * 256 * 512),
    ("label_join_rowmin", (256, 128), 2, 2 * 256 * 128, 16 * 256 * 128),
    # label_join: the same inputs, the [B] minima out
    ("label_join", (256, 512), 4, 3 * 256 * 512, 16 * 256 * 512 + 4 * 256),
    ("label_join", (33, 384), 2, 3 * 33 * 384, 12 * 33 * 384 + 4 * 33),
])
def test_kernel_cost_matches_hand_counts(name, shape, dist_bytes, ops_,
                                         bytes_):
    assert obs.kernel_cost(name, shape, dist_bytes) == \
        {"ops": ops_, "bytes": bytes_}


def test_kernel_cost_counters_follow_the_installed_capture():
    from repro_torch.obs import profile

    with pytest.raises(ValueError):
        obs.kernel_cost("no_such_kernel", (1, 1))
    reg = obs.MetricsRegistry()
    profile.note_kernel("segvis", (256, 128))          # none installed
    with obs.profiled(registry=reg):
        profile.note_kernel("segvis", (256, 128))
        profile.note_kernel("segvis", (256, 128))
        profile.note_kernel("label_join_rowmin", (256, 512), 2)
    profile.note_kernel("segvis", (256, 128))          # uninstalled
    seg = obs.kernel_cost("segvis", (256, 128))
    join = obs.kernel_cost("label_join_rowmin", (256, 512), 2)
    assert _series(reg, "kernel_cost_ops_total") == {
        "segvis": 2 * seg["ops"], "label_join_rowmin": join["ops"]}
    assert _series(reg, "kernel_cost_bytes_total") == {
        "segvis": 2 * seg["bytes"], "label_join_rowmin": join["bytes"]}


# ------------------------------------------------------- build and load

def test_build_and_load_series_follow_fake_nvcc(tmp_path, monkeypatch):
    """Each nvcc build and ctypes load adds one to its kernel's series in
    the process-wide registry; build seconds
    grow with every build."""
    from repro_torch.kernels import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("cp ", "sleep 0.05; cp "))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake_a.cu").write_text("// a\n")
    (csrc / "fake_b.cu").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())

    def series(name):
        return {k: v for k, v in _series(obs.REGISTRY, name).items()
                if k in ("fake_a", "fake_b")}

    base = {n: series(n) for n in ("kernel_builds_total",
                                   "kernel_loads_total",
                                   "kernel_build_seconds_total")}

    def grown(name):
        return {k: v - base[name].get(k, 0) for k, v in series(name).items()
                if v != base[name].get(k, 0)}

    build.build(("fake_a", "fake_b"))
    assert grown("kernel_builds_total") == {"fake_a": 1, "fake_b": 1}
    secs = grown("kernel_build_seconds_total")
    assert set(secs) == {"fake_a", "fake_b"}
    assert all(v >= 0.05 for v in secs.values())
    build.load("fake_a")
    build.load("fake_a")
    assert grown("kernel_loads_total") == {"fake_a": 1}
    (csrc / "fake_a.cu").write_text("// a, edited\n")
    build.build(("fake_a", "fake_b"))
    assert grown("kernel_builds_total") == {"fake_a": 2, "fake_b": 1}


# ------------------------------------------------------- label_join entry

def _rand_join(rng, b, l, hubs=64):
    """The reference's kernel-test rows (tests/test_kernels.py): sorted
    hubs, uniform distances with a fifth invisible."""
    hub_s = np.sort(rng.integers(0, hubs, (b, l)).astype(np.int32), axis=1)
    hub_t = np.sort(rng.integers(0, hubs, (b, l)).astype(np.int32), axis=1)
    vd_s = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vd_t = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vd_s[rng.random((b, l)) < 0.2] = np.inf
    vd_t[rng.random((b, l)) < 0.2] = np.inf
    return hub_s, vd_s, hub_t, vd_t


def _both(rows, dtype: str):
    """The same rows as reference (jax) and port (torch) operands, the
    distances rounded to ``dtype`` alike."""
    hs, vs, ht, vt = rows
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    ref = (jnp.asarray(hs), jnp.asarray(vs, jdt), jnp.asarray(ht),
           jnp.asarray(vt, jdt))
    port = (torch.from_numpy(hs), torch.from_numpy(vs).to(tdt),
            torch.from_numpy(ht), torch.from_numpy(vt).to(tdt))
    return ref, port


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 5, 8, 33])
@pytest.mark.parametrize("l", [16, 128, 384])
def test_label_join_kernel_equals_reference(b, l, dtype):
    ref, port = _both(_rand_join(np.random.default_rng(b * 7919 + l), b, l),
                      dtype)
    want = np.asarray(ref_ops.label_join_kernel(*ref, interpret=True))
    got = ops.label_join_kernel(*port)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), ops.label_join_rowmin_ref(*port).amin(-1).numpy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,l,hubs", [(8, 64, 32), (33, 128, 96)])
def test_label_join_hubdense_ref_equals_reference(b, l, hubs, dtype):
    """Against the reference's hub-scatter twin (pads at ``hubs`` and
    above dropped), and equal to ``label_join_ref`` where every hub is
    valid."""
    rng = np.random.default_rng(b + l)
    hs, vs, ht, vt = _rand_join(rng, b, l, hubs=hubs)
    ref, port = _both((hs, vs, ht, vt), dtype)
    got = ops.label_join_hubdense_ref(*port, hubs)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(ref_ops.label_join_hubdense_ref(*ref, hubs)), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(),
                                  ops.label_join_ref(*port).numpy())
    # padded tails (hub id >= hubs) are dropped by both
    hs_p, ht_p = hs.copy(), ht.copy()
    hs_p[:, l // 2:] = 1 << 30
    ht_p[:, 3 * l // 4:] = 1 << 30
    ref, port = _both((hs_p, vs, ht_p, vt), dtype)
    np.testing.assert_allclose(
        ops.label_join_hubdense_ref(*port, hubs).numpy(),
        np.asarray(ref_ops.label_join_hubdense_ref(*ref, hubs)), rtol=1e-6)
