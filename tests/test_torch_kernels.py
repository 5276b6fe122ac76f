"""Port kernels' plain twins vs the JAX reference oracles and Pallas kernels.

The same numpy inputs go through ``repro.kernels`` (jnp oracle and the
Pallas kernel in interpret mode) and ``repro_torch.kernels`` (the torch
twin, which the CUDA kernels equal bit for bit on the card).  Visibility
bits must be equal; the row join must be equal too, since a min and one
add are exact in IEEE arithmetic.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import packed as ref_packed
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.label_join import label_join_rowmin as pallas_rowmin
from repro.kernels.segvis import segvis as pallas_segvis
from repro_torch.core import packed as port_packed
from repro_torch.kernels import label_join as cuda_label_join
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segvis as cuda_segvis

from test_segvis_convention import DEGENERATE_CASES, SQ


def _rand_segs(rng, n, e):
    return tuple(rng.uniform(0, 10, (k, 2)).astype(np.float32)
                 for k in (n, n, e, e, e))


def test_cross3_matches_jax():
    args = np.random.default_rng(2).uniform(-5, 5, (6, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.cross3(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jref.cross3(*map(jnp.asarray, args))))


def _segvis_all(p, q, ea, eb, ec):
    """(port twin, jnp oracle, Pallas interpret) verdicts as numpy bools."""
    t = [torch.from_numpy(a) for a in (p, q, ea, eb, ec)]
    j = [jnp.asarray(a) for a in (p, q, ea, eb, ec)]
    return (ref.segvis_ref(*t).numpy(), np.asarray(jops.segvis_ref(*j)),
            np.asarray(pallas_segvis(*j, interpret=True)))


@pytest.mark.parametrize("n", [1, 7, 256, 300])
@pytest.mark.parametrize("e", [1, 64, 512, 700])
def test_segvis_twin_matches_jax(n, e):
    rng = np.random.default_rng(n * 1000 + e)
    port, oracle, kernel = _segvis_all(*_rand_segs(rng, n, e))
    np.testing.assert_array_equal(port, oracle)
    np.testing.assert_array_equal(port, kernel)


def test_segvis_twin_degenerate_contacts():
    """The DESIGN.md §5 degenerate-contact table, bit for bit."""
    P = np.array([c[0] for c in DEGENERATE_CASES], np.float32)
    Q = np.array([c[1] for c in DEGENERATE_CASES], np.float32)
    want = ~np.array([c[2] for c in DEGENERATE_CASES])
    A, B, C = (a.astype(np.float32) for a in
               (SQ.edges[:, 0], SQ.edges[:, 1], SQ.edge_next))
    port, oracle, kernel = _segvis_all(P, Q, A, B, C)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port, oracle)
    np.testing.assert_array_equal(port, kernel)


def test_segvis_twin_vertex_anchored(scene_s):
    """Segments ending exactly on polygon vertices (every via segment)."""
    rng = np.random.default_rng(7)
    V = scene_s.vertices.astype(np.float32)
    P = rng.uniform(0, [scene_s.width, scene_s.height],
                    (len(V), 2)).astype(np.float32)
    A, B, C = (a.astype(np.float32) for a in
               (scene_s.edges[:, 0], scene_s.edges[:, 1], scene_s.edge_next))
    port, oracle, _ = _segvis_all(P, V, A, B, C)
    np.testing.assert_array_equal(port, oracle)


def _rand_join(rng, b, l, hubs=64):
    hub_s = np.sort(rng.integers(0, hubs, (b, l)).astype(np.int32), axis=1)
    hub_t = np.sort(rng.integers(0, hubs, (b, l)).astype(np.int32), axis=1)
    vd_s = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vd_t = rng.uniform(0, 100, (b, l)).astype(np.float32)
    vd_s[rng.random((b, l)) < 0.2] = np.inf
    vd_t[rng.random((b, l)) < 0.2] = np.inf
    return hub_s, vd_s, hub_t, vd_t


@pytest.mark.parametrize("b", [1, 5, 8, 33])
@pytest.mark.parametrize("l", [16, 128, 384])
def test_rowmin_twin_matches_jax(b, l):
    args = _rand_join(np.random.default_rng(b * 7919 + l), b, l)
    port = ref.label_join_rowmin_ref(*map(torch.from_numpy, args)).numpy()
    j = [jnp.asarray(a) for a in args]
    np.testing.assert_array_equal(port, np.asarray(
        jops.label_join_rowmin_ref(*j)))
    np.testing.assert_array_equal(port, np.asarray(
        pallas_rowmin(*j, interpret=True)))
    np.testing.assert_array_equal(
        ref.label_join_ref(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jops.label_join_ref(*j)))


def test_rowmin_twin_all_inf_and_padding():
    """No hub match (pads vs real hubs) and all-inf rows give +inf."""
    b, l = 4, 128
    hs = np.zeros((b, l), np.int32)
    ht = np.full((b, l), int(port_packed.HUB_PAD), np.int32)
    vs = np.ones((b, l), np.float32)
    out = ref.label_join_rowmin_ref(*map(torch.from_numpy, (hs, vs, ht, vs)))
    assert torch.isinf(out).all()
    inf = np.full((b, l), np.inf, np.float32)
    out = ref.label_join_rowmin_ref(*map(torch.from_numpy, (hs, inf, hs, inf)))
    assert torch.isinf(out).all()


def test_argmin_ties_resolve_to_first_index():
    """Tied rows pick the first i and the first j in both packages."""
    rng = np.random.default_rng(4)
    B, L = 16, 128
    hub_s = np.sort(rng.integers(0, 6, (B, L)).astype(np.int32), axis=1)
    hub_t = np.sort(rng.integers(0, 6, (B, L)).astype(np.int32), axis=1)
    # few distinct distances: many exact ties in every row and column
    vd_s = rng.integers(0, 3, (B, L)).astype(np.float32)
    vd_t = rng.integers(0, 3, (B, L)).astype(np.float32)
    vid_s = rng.integers(0, 1000, (B, L)).astype(np.int32)
    vid_t = rng.integers(0, 1000, (B, L)).astype(np.int32)
    s = rng.uniform(0, 10, (B, 2)).astype(np.float32)
    t = rng.uniform(0, 10, (B, 2)).astype(np.float32)
    covis = np.zeros(B, bool)
    want = ref_packed._join_masked(
        tuple(map(jnp.asarray, (hub_s, vd_s, vid_s))),
        tuple(map(jnp.asarray, (hub_t, vd_t, vid_t))),
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(covis),
        use_kernels=False, want_argmin=True)
    got = port_packed._join_masked(
        tuple(map(torch.from_numpy, (hub_s, vd_s, vid_s))),
        tuple(map(torch.from_numpy, (hub_t, vd_t, vid_t))),
        torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(covis),
        use_kernels=False, want_argmin=True)
    for name, w, g in zip(("d", "covis", "via_s", "hub", "via_t"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_ops_dispatch_runs_twins_on_cpu():
    """CPU tensors go to the twins and never count a kernel launch."""
    rng = np.random.default_rng(0)
    seg = [torch.from_numpy(a) for a in _rand_segs(rng, 9, 5)]
    join = [torch.from_numpy(a) for a in _rand_join(rng, 3, 16)]
    launches = (cuda_segvis.segvis.launches,
                cuda_label_join.label_join_rowmin.launches)
    calls = (ref.segvis_ref.calls, ref.label_join_rowmin_ref.calls)
    assert torch.equal(ops.segvis_kernel(*seg), ref.segvis_ref(*seg))
    assert torch.equal(ops.label_join_rowmin_kernel(*join),
                       ref.label_join_rowmin_ref(*join))
    assert (ref.segvis_ref.calls, ref.label_join_rowmin_ref.calls) == \
        (calls[0] + 2, calls[1] + 2)
    assert (cuda_segvis.segvis.launches,
            cuda_label_join.label_join_rowmin.launches) == launches


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises — it never falls back."""
    rng = np.random.default_rng(1)
    seg = [torch.from_numpy(a) for a in _rand_segs(rng, 4, 3)]
    join = [torch.from_numpy(a) for a in _rand_join(rng, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_segvis.segvis(*seg)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_label_join.label_join_rowmin(*join)


FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
if grep -q FAIL "$src"; then echo "error: bad source"; exit 1; fi
echo "ptxas info    : Used 8 registers"; cp "$src" "$out"
"""


def test_build_compiles_once_keyed_by_source(tmp_path, monkeypatch):
    """Each source builds once into a hash-named library; a changed source
    or shared header builds anew; a failed build raises with the compiler's
    output and leaves no library behind."""
    from repro_torch.kernels import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))

    logs = build.build(("a", "b"))
    assert sorted(logs) == ["a", "b"] and "registers" in logs["a"]
    lib_a = build.library_path("a")
    assert lib_a.read_text() == "// a\n"
    assert build.build(("a", "b")) == {}                # nothing to rebuild
    (csrc / "a.cu").write_text("// a, edited\n")
    assert build.library_path("a") != lib_a
    assert sorted(build.build(("a", "b"))) == ["a"]
    # a shared header is part of every library's key: editing it rebuilds
    (csrc / "shared.cuh").write_text("// shared\n")
    keyed = {n: build.library_path(n) for n in ("a", "b")}
    assert sorted(build.build(("a", "b"))) == ["a", "b"]
    (csrc / "shared.cuh").write_text("// shared, edited\n")
    assert all(build.library_path(n) != keyed[n] for n in ("a", "b"))
    assert sorted(build.build(("a", "b"))) == ["a", "b"]
    assert build.build(("a", "b")) == {}
    (csrc / "b.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="bad source"):
        build.build(("a", "b"))
    assert not build.library_path("b").exists()
    assert not list((tmp_path / "out").glob("*.tmp"))


def test_load_builds_and_loads_once_across_threads(tmp_path, monkeypatch):
    """Two threads that meet a kernel first at the same moment (the
    adaptive manager's build thread beside a serving thread) make one nvcc
    build and one load between them, and get the same library."""
    import threading

    from repro_torch.kernels import build
    from repro_torch.obs import REGISTRY

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("cp ", "sleep 0.3; cp "))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    builds0, loads0 = (REGISTRY.total(n, kernel="a") for n in
                       ("kernel_builds_total", "kernel_loads_total"))
    start = threading.Barrier(2)
    got = []

    def first_use():
        start.wait()
        got.append(build.load("a"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert len(got) == 2 and got[0] is got[1]
    assert REGISTRY.total("kernel_builds_total", kernel="a") == builds0 + 1
    assert REGISTRY.total("kernel_loads_total", kernel="a") == loads0 + 1
    assert build.library_path("a").read_text() == "// a\n"
    assert not list((tmp_path / "out").glob("*.tmp"))
