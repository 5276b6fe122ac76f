"""Clustered traffic and a history-scored index, from data files alone: the
cluster sampler, the uniform draws kept as they were, the cache keys and
builds of the host index, and a workload-aware cell added as new files."""

import hashlib
import json
import math
import pickle
from pathlib import Path

import numpy as np
import pytest

from conftest import ROOT, run_tiny
from test_portbench_throwaway import _digest

from portbench import harness, traffic
from portbench.scene import CLEARANCE, Map

CFG = json.loads((ROOT / "portbench/configs/rooms-L.ehl20.f32.json")
                 .read_text())
M = Map(CFG["map"])
HOT = {"k": 8, "side_frac": 0.10, "seed": 7}
SCORED = {"history_pairs": 4000, "history_seed": 11}


def _spec(adherence, loop="closed"):
    return {"loop": loop, "distribution": "cluster", "clusters": HOT,
            "adherence": adherence, "pairs_per_request": [64, 64],
            "max_requests_per_s": 20, "rate_per_s": 100}


def _in_rects(p, rects):
    p = p.astype(np.float64)[:, None, :]
    return ((p[..., 0] >= rects[:, 0]) & (p[..., 0] <= rects[:, 2])
            & (p[..., 1] >= rects[:, 1]) & (p[..., 1] <= rects[:, 3]))


def _clear(m, p):
    """Every point inside the map and CLEARANCE away from every obstacle,
    judged in float64 on the float32 points."""
    x, y = p[:, 0].astype(np.float64), p[:, 1].astype(np.float64)
    ok = (x >= 0) & (x <= m.width) & (y >= 0) & (y <= m.height)
    for x0, y0, x1, y1 in m.rects:
        ok &= ~((x > x0 - CLEARANCE) & (x < x1 + CLEARANCE)
                & (y > y0 - CLEARANCE) & (y < y1 + CLEARANCE))
    return bool(ok.all())


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 9])
def test_hot_spots_come_from_the_configurations_seed(seed):
    spec = dict(HOT, seed=seed)
    a = traffic.cluster_rects(M, spec)
    assert np.array_equal(a, traffic.cluster_rects(M, spec))
    assert not np.array_equal(a, traffic.cluster_rects(M, dict(HOT, seed=3)))
    assert a.shape == (HOT["k"], 4)
    assert np.allclose(a[:, 2] - a[:, 0], 0.10 * M.width)
    assert np.allclose(a[:, 3] - a[:, 1], 0.10 * M.height)
    assert (a[:, :2] >= 0).all() and (a[:, 2] <= M.width).all() \
        and (a[:, 3] <= M.height).all()
    # each holds free points: the sampler finds some in every one
    g = np.random.default_rng(0)
    pts = traffic.cluster_points(M, a, np.repeat(np.arange(len(a)), 16), g)
    assert _clear(M, pts)
    assert _in_rects(pts, a)[np.arange(len(pts)),
                             np.repeat(np.arange(len(a)), 16)].all()


@pytest.mark.parametrize("adherence", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_cluster_traffic(adherence, loop):
    spec = _spec(adherence, loop=loop)
    run_seed = 2 ** 31 + 77
    a = traffic.make(spec, M, 10.0, traffic.rng(run_seed, traffic.TRAFFIC))
    b = traffic.make(spec, M, 10.0, traffic.rng(run_seed, traffic.TRAFFIC))
    c = traffic.make(spec, M, 10.0, traffic.rng(run_seed + 1,
                                                traffic.TRAFFIC))
    assert np.array_equal(a.s, b.s) and np.array_equal(a.t, b.t)
    assert np.array_equal(a.lo, b.lo)
    assert not np.array_equal(a.s, c.s)
    assert a.s.dtype == a.t.dtype == np.float32
    assert _clear(M, a.s) and _clear(M, a.t)

    rects = traffic.cluster_rects(M, HOT)
    n = len(a.s)
    ins, int_ = _in_rects(a.s, rects), _in_rects(a.t, rects)
    share = float(np.mean(ins.any(1) & int_.any(1)))
    # uniform pairs land in the hot spots too, at the share q
    u = traffic.make(dict(spec, distribution="uniform"), M, 20.0,
                     traffic.rng(5, traffic.TRAFFIC))
    q = float(np.mean(_in_rects(u.s, rects).any(1)
                      & _in_rects(u.t, rects).any(1)))
    expect = adherence + (1 - adherence) * q
    sigma = math.sqrt((1 - adherence) * q * (1 - q) / n
                      + (1 - adherence) ** 2 * q * (1 - q) / len(u.s))
    assert abs(share - expect) <= 3 * sigma + 1.0 / n, (share, expect)
    if adherence == 1.0:
        # s and t in independently drawn hot spots: in one and in two
        same = (ins & int_).any(1)
        assert 0 < same.mean() < 0.5


def _requests_digest(r):
    h = hashlib.sha256()
    for x in (r.s, r.t, r.lo) + ((r.due,) if r.due is not None else ()):
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()[:16]


#: digests of the uniform requests before the cluster sampler existed
UNIFORM = {("ehl20-f32.batch-uniform", 3000000123): "386537532b49e479",
           ("ehl20-f32.batch-uniform", 5): "28a80fa28ecc9835",
           ("ehl20-bf16.paths-uniform", 3000000123): "6e30253b06526f4b",
           ("ehl20-bf16.paths-uniform", 5): "b09c03fe2800df08",
           ("ehl20-bf16.batch-uniform", 3000000123): "a6b8c021b9b929f1",
           ("ehl20-bf16.batch-uniform", 5): "d4086a529028a447",
           ("open", 3000000123): "a88197235d96291c",
           ("open", 5): "bfb8e9a56928c429"}
OPEN = {"loop": "open", "distribution": "uniform",
        "pairs_per_request": [1, 16], "rate_per_s": 1360}


@pytest.mark.parametrize("cell,seed", list(UNIFORM), ids=str)
def test_uniform_requests_as_before(cell, seed):
    spec = OPEN if cell == "open" else json.loads(
        (ROOT / "portbench/workloads" / f"{cell}.json").read_text())
    r = traffic.make(spec, M, 0.5, traffic.rng(seed, traffic.TRAFFIC))
    assert _requests_digest(r) == UNIFORM[(cell, seed)]


def _key_before(cfg):
    """The cache key as it was computed before the ``workload_aware``
    block existed."""
    import repro_torch.core as core
    h = hashlib.sha256(json.dumps(
        [cfg["map"], cfg["cell_size"], cfg["budget"]],
        sort_keys=True).encode())
    for src in sorted(Path(core.__file__).parent.glob("*.py")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]])
def test_cache_key_without_the_block_as_before(name):
    cfg = json.loads((ROOT / "portbench/configs" / f"{name}.json")
                     .read_text())
    assert harness.index_key(cfg) == _key_before(cfg)
    # hot spots alone change nothing the index is made from
    assert harness.index_key(dict(cfg, clusters=HOT)) == _key_before(cfg)
    scored = dict(cfg, clusters=HOT, workload_aware=SCORED)
    keys = {harness.index_key(scored),
            harness.index_key(dict(scored, clusters=dict(HOT, seed=8))),
            harness.index_key(dict(scored, workload_aware=dict(
                SCORED, history_pairs=4001)))}
    assert len(keys) == 3 and _key_before(cfg) not in keys


@pytest.mark.parametrize("changed", [None, 0, 1])
def test_scored_key_follows_the_sampler(tmp_path, monkeypatch, changed):
    """The history that scores a workload-aware index is drawn by the
    benchmark's sampler: a change to either of its sources keys a new
    index, copies of the same bytes key the same one, and a configuration
    without the block keeps its key."""
    cfg = json.loads(json.dumps(CFG))
    scored = dict(cfg, clusters=HOT, workload_aware=SCORED)
    keys = harness.index_key(cfg), harness.index_key(scored)
    copies = []
    for j, orig in enumerate(harness.SAMPLER):
        copy = tmp_path / str(j) / orig.name
        copy.parent.mkdir()
        copy.write_bytes(orig.read_bytes()
                         + (b"\n# changed\n" if j == changed else b""))
        copies.append(copy)
    monkeypatch.setattr(harness, "SAMPLER", tuple(copies))
    assert harness.index_key(cfg) == keys[0]
    assert (harness.index_key(scored) == keys[1]) == (changed is None)


def _tiny_config():
    cfg = json.loads(json.dumps(CFG))
    cfg["map"]["params"].update(n_rooms=4, width=30.0, height=30.0)
    return cfg


def _same(a, b):
    """Deep equality of two host indexes, arrays by dtype and values."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and _same(vars(a), vars(b))
    return a == b


def test_one_uncompressed_build_per_map(tmp_path):
    """A configuration merges a copy of the map's one uncompressed build:
    the first build merges in place, as the index was always built (the
    same pickle bytes), and a later budget merges a copy loaded from the
    cache to the same index as a fresh build would."""
    from repro_torch.core.compression import compress_to_fraction
    from repro_torch.core.geometry import Scene
    from repro_torch.core.grid import build_ehl
    from repro_torch.core.visgraph import build_visgraph

    cfg = _tiny_config()
    m = Map(cfg["map"])
    cell = harness.Cell("t", "t", cfg, {}, [], [], tmp_path, 1)
    built, fresh = harness.host_index(cell, m)
    assert fresh
    scene = Scene.build(m.polygons(), m.width, m.height)
    before = build_ehl(scene, cfg["cell_size"], graph=build_visgraph(scene))
    compress_to_fraction(before, cfg["budget"])
    dump = lambda x: pickle.dumps(x, protocol=pickle.HIGHEST_PROTOCOL)  # noqa
    assert dump(built) == dump(before)

    (tmp_path / ".cache" / f"ehl-{harness.index_key(cfg)}.pkl").unlink()
    copied, fresh = harness.host_index(cell, m)
    assert fresh and _same(copied, built)
    assert harness.host_index(cell, m)[1] is False

    cell.config = dict(cfg, budget=0.5)
    other, _ = harness.host_index(cell, m)
    assert len(other.regions) > len(built.regions)
    assert len(list((tmp_path / ".cache").glob("base-*.pkl"))) == 1
    assert len(list((tmp_path / ".cache").glob("ehl-*.pkl"))) == 2


def _add_cluster_cells(root):
    """A workload-aware configuration, its unscored twin with the same hot
    spots, and a clustered cell on each: new files and new entries of
    BENCHMARK.json only."""
    data = root / "portbench"
    base = json.loads((data / "configs/tiny.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    hot = {"k": 4, "side_frac": 0.10, "seed": 21}
    for name, extra in (("tiny-hot", {"clusters": hot}),
                        ("tiny-scored", {"clusters": hot, "workload_aware": {
                            "history_pairs": 3000, "history_seed": 4}})):
        cfg = dict(base, name=name, **extra)
        (data / f"configs/{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        wl = json.loads((data / "workloads/tiny.batch.json").read_text())
        wl.update(name=f"{name}.cluster", config=name, traffic="cluster",
                  distribution="cluster", adherence=0.8)
        (data / f"workloads/{name}.cluster.json").write_text(json.dumps(wl))
        bench["workloads"].append({"name": f"{name}.cluster", "config": name,
                                   "traffic": "cluster", "chips": 1,
                                   "why": "test"})
        for metric in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in metric:
                metric["workloads"].append(f"{name}.cluster")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_scored_index_merges_differently_and_both_are_correct(tiny_root):
    _add_cluster_cells(tiny_root)
    idx = {}
    for name in ("tiny-hot", "tiny-scored"):
        res, _ = run_tiny(tiny_root, f"{name}.cluster", seed=2 ** 31 + 3)
        assert res["correct"] is True, res["checks"]
        cell = harness.load_cell(f"{name}.cluster", tiny_root)
        idx[name], built = harness.host_index(cell, Map(cell.config["map"]))
        assert not built
    a, b = idx["tiny-hot"], idx["tiny-scored"]
    assert a.label_memory() > 0 and b.label_memory() > 0
    assert not np.array_equal(a.mapper, b.mapper)


def test_workload_aware_cell_from_new_files_only(tiny_root):
    before = _digest(tiny_root)
    _add_cluster_cells(tiny_root)
    res, _ = run_tiny(tiny_root, "tiny-scored.cluster", trace=True)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["route.us_per_query"]["value"] > 0
    cell = harness.load_cell("tiny-scored.cluster", tiny_root)
    assert cell.workload["clusters"] == cell.config["clusters"]
    after = _digest(tiny_root)
    assert [k for k in before if before[k] != after.get(k)] == []


def test_cluster_traffic_needs_the_configurations_hot_spots(tiny_root):
    spec = _spec(1.0)
    del spec["clusters"]
    with pytest.raises(ValueError, match="clusters"):
        traffic.make(spec, M, 1.0, traffic.rng(1, traffic.TRAFFIC))
    with pytest.raises(ValueError, match="unknown query distribution"):
        traffic.make(dict(spec, distribution="zipf"), M, 1.0,
                     traffic.rng(1, traffic.TRAFFIC))
    _add_cluster_cells(tiny_root)
    wl = tiny_root / "portbench/workloads/tiny-hot.cluster.json"
    wl.write_text(json.dumps(dict(json.loads(wl.read_text()), clusters=HOT)))
    with pytest.raises(ValueError, match="configuration"):
        harness.load_cell("tiny-hot.cluster", tiny_root)
