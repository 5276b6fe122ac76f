"""Port query path and PathServer vs the JAX reference (rooms-S, 0.2, CPU).

The port answers from its own host index and pack; the reference answers
through its unpadded ``query_batch_bucketed``.  Distances agree to rtol 1e-6
(the via-distance norm may round one ulp apart), co-visibility exactly,
argmin ids exactly except on rows tied in the join, and both stay within
1e-4 of the float64 host oracle.  Also the port's two guard rules: no module
imports JAX or the reference package, and the entry points refuse a CUDA
default when no card is present.
"""

import ast
import pathlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from repro.core import packed as ref_packed
from repro.core.workload import uniform_queries
from repro_torch.core import packed as port_packed
from repro_torch.core.compression import compress_to_fraction
from repro_torch.core.grid import build_ehl
from repro_torch.core.maps import make_map
from repro_torch.core.query import path_length
from repro_torch.core.visgraph import build_visgraph
from repro_torch.kernels import ref as port_ref
from repro_torch.serving import (CudaEngine, HostEngine, PathServer,
                                 TorchEngine, make_engine)

HOST_TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_index():
    scene = make_map("rooms-S", seed=1)
    idx = build_ehl(scene, cell_size=2.0, graph=build_visgraph(scene))
    compress_to_fraction(idx, 0.2)
    return idx


@pytest.fixture(scope="module")
def port_bx(port_index):
    return port_packed.pack_bucketed(port_index, device="cpu")


@pytest.fixture(scope="module")
def queries(scene_s, graph_s):
    qs = uniform_queries(scene_s, graph_s, 160, seed=23)
    return qs.s.astype(np.float32), qs.t.astype(np.float32)


@pytest.fixture(scope="module")
def reference_answers(compressed_s, queries):
    bx = ref_packed.pack_bucketed(compressed_s[0], edge_grid=False)
    return tuple(np.asarray(a) for a in ref_packed.query_batch_bucketed(
        bx, *queries, want_argmin=True))


def tied_rows(bx, s, t, rtol=1e-6) -> np.ndarray:
    """[N] bool — rows whose join has a second candidate within ``rtol`` of
    the winner (for i over the row join, or for j at the winning hub)."""
    buckets = port_packed.dispatch_buckets(bx, s, t)
    tied = np.zeros(len(s), bool)
    for k in np.unique(buckets):
        m = buckets == k
        sk, tk = torch.from_numpy(s[m]), torch.from_numpy(t[m])
        hs, vs, _ = port_packed._fold_endpoint(bx, sk, int(k))
        ht, vt, _ = port_packed._fold_endpoint(bx, tk, int(k))
        rowmin = port_ref.label_join_rowmin_ref(hs, vs, ht, vt)
        best = rowmin.amin(-1, keepdim=True)
        near_i = (rowmin <= best * (1 + rtol)) & torch.isfinite(rowmin)
        hub_i = torch.gather(hs, 1, rowmin.argmin(-1, keepdim=True))
        cand = torch.where(ht == hub_i, vt, torch.tensor(float("inf")))
        best_j = cand.amin(-1, keepdim=True)
        near_j = (cand <= best_j * (1 + rtol)) & torch.isfinite(cand)
        tied[m] = ((near_i.sum(-1) > 1) | (near_j.sum(-1) > 1)).numpy()
    return tied


def assert_matches_reference(got, want, tied):
    d, covis, via_s, hub, via_t = got
    np.testing.assert_allclose(d, want[0], rtol=1e-6)
    np.testing.assert_array_equal(covis, want[1])
    ids_differ = ((via_s != want[2]) | (hub != want[3]) | (via_t != want[4]))
    assert not (ids_differ & ~tied).any(), np.nonzero(ids_differ & ~tied)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_query_batch_bucketed_matches_reference(port_bx, queries,
                                                reference_answers,
                                                use_kernels):
    got = port_packed.query_batch_bucketed(port_bx, *queries,
                                           use_kernels=use_kernels,
                                           want_argmin=True)
    assert [a.dtype for a in got] == [a.dtype for a in reference_answers]
    assert_matches_reference(got, reference_answers,
                             tied_rows(port_bx, *queries))
    d = port_packed.query_batch_bucketed(port_bx, *queries,
                                         use_kernels=use_kernels)
    np.testing.assert_array_equal(d, got[0])


def test_distances_match_float64_truth(port_bx, compressed_s, queries_s):
    _, truth = compressed_s
    d = port_packed.query_batch_bucketed(port_bx, queries_s.s, queries_s.t)
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(truth))
    fin = np.isfinite(truth)
    np.testing.assert_allclose(d[fin], truth[fin], rtol=HOST_TOL,
                               atol=HOST_TOL)


@pytest.mark.parametrize("engine_cls", [TorchEngine, CudaEngine])
def test_path_server_matches_reference(port_bx, port_index, queries,
                                       reference_answers, engine_cls):
    srv = PathServer(engine_cls(port_bx), batch_size=32)
    srv.warmup(paths=True)
    s, t = queries
    d = srv.query(s, t)
    np.testing.assert_allclose(d, reference_answers[0], rtol=1e-6)
    dp, paths = srv.query_paths(s[:48], t[:48], host_index=port_index)
    np.testing.assert_array_equal(dp, d[:48])
    for di, p in zip(dp, paths):
        if np.isfinite(di):
            assert abs(path_length(p) - di) <= HOST_TOL * max(1.0, di)
        else:
            assert p == []
    assert srv.stats.queries == len(s) + 48
    assert sum(b.queries for b in srv.stats.per_bucket.values()) == \
        len(s) + 48
    assert all(0 < b.occupancy <= 1 for b in srv.stats.per_bucket.values())


def test_path_server_engines_agree_bitwise(port_bx, queries):
    """The kernel path (twins on CPU tensors) and the twin path are one
    computation: every output equal."""
    s, t = queries
    a = PathServer(TorchEngine(port_bx), batch_size=64)
    b = PathServer(CudaEngine(port_bx), batch_size=64)
    for x, y in zip(a._dispatch(s, t, want_argmin=True),
                    b._dispatch(s, t, want_argmin=True)):
        np.testing.assert_array_equal(x, y)


def test_host_engine_server_matches_truth(port_index, compressed_s,
                                          queries_s):
    _, truth = compressed_s
    srv = PathServer(make_engine(port_index, backend="host"), batch_size=8)
    d = srv.query(queries_s.s, queries_s.t)
    fin = np.isfinite(truth)
    np.testing.assert_allclose(d[fin], truth[fin], rtol=HOST_TOL,
                               atol=HOST_TOL)
    dp, paths = srv.query_paths(queries_s.s[:6], queries_s.t[:6])
    np.testing.assert_allclose(dp, d[:6], rtol=HOST_TOL)


def test_default_device_raises_without_cuda(port_index, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_packed.pack_bucketed(port_index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine(port_index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PathServer(port_index)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "examples" / "pathfind_serve_torch.py",
        REPO / "examples" / "serve_timing_torch.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        # ml_dtypes ships with jax, not on the card's machine: the port
        # rounds bf16 with torch
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path}: {mod}"
