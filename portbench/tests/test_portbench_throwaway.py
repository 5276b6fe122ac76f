"""A configuration, a cell and a per-layer metric added as new files and
new entries of BENCHMARK.json, with no file of the benchmark edited."""

import hashlib
import json

from conftest import ROOT, run_tiny

METRIC = '''"""Requests the traced window's spans saw."""

NAME = "throwaway.requests"
UNIT = "requests"
LAYER = "serving.engine: test"
SOURCE = "program_span"
MOVES = "qps"


def read(ctx):
    return len(ctx.traces) or None
'''


def _digest(root):
    h = {}
    for p in sorted((root / "portbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h[str(p.relative_to(root))] = hashlib.sha256(
                p.read_bytes()).hexdigest()
    return h


def test_throwaway_cell(tiny_root):
    before = _digest(tiny_root)
    data = tiny_root / "portbench"
    cfg = json.loads((data / "configs/tiny.json").read_text())
    cfg.update(name="throwaway-map", layout="f32",
               guarantee={"distance": "f32", "text": "exact"},
               limits={"dist_rel_gap": 1e-3, "missing": 0})
    cfg["map"]["seed"] = 5
    (data / "configs/throwaway-map.json").write_text(json.dumps(cfg))
    wl = json.loads((data / "workloads/tiny.batch.json").read_text())
    wl.update(name="throwaway-map.batch", config="throwaway-map")
    (data / "workloads/throwaway-map.batch.json").write_text(json.dumps(wl))
    (data / "metrics/throwaway.requests.py").write_text(METRIC)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-map", "source": "test",
                             "file": "portbench/configs/throwaway-map.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway-map.batch",
                               "config": "throwaway-map",
                               "traffic": "batch", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "throwaway.requests",
                               "unit": "requests", "better": "higher",
                               "source": "program_span",
                               "layer": "serving.engine: test",
                               "moves": "qps",
                               "workloads": ["throwaway-map.batch"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res, _ = run_tiny(tiny_root, "throwaway-map.batch", trace=True)
    assert res["correct"] is True
    assert res["metrics"]["throwaway.requests"]["value"] > 0
    after = _digest(tiny_root)
    changed = [k for k in before if before[k] != after.get(k)]
    assert changed == []
    assert ROOT != tiny_root
