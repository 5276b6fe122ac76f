"""BENCHMARK.json against the benchmark contract, and every file it names
found by name."""

import importlib.util
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24        # the most a benchmark may grow to
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
            assert not key.endswith(("_dim", "_rank"))
        assert set(cfg["limits"]) >= {"missing"}


def test_cells():
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = json.loads((ROOT / "portbench/workloads" /
                         f"{w['name']}.json").read_text())
        assert (wl["name"], wl["config"], wl["traffic"]) == \
            (w["name"], w["config"], w["traffic"])
        assert wl["loop"] in ("closed", "open")
        assert wl["entry"] in ("query", "query_paths", "submit")
    assert len(set(CELLS)) == len(CELLS)
    assert four <= max(1, len(CELLS) // 4)


def test_end_to_end():
    assert "setup_s" in E2E
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_file(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert _line(metric["layer"]) and metric["moves"] in E2E
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert set(metric["workloads"]) <= set(CELLS)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"
    path = ROOT / "portbench/metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        metric["name"], metric["unit"], metric["layer"], metric["source"],
        metric["moves"])
    assert callable(mod.read)


def test_one_layer_one_name():
    by_file = {}
    for m in BENCH["per_layer"]:
        by_file.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_file.values()), by_file


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    from portbench import harness
    c = harness.load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert {m["moves"] for m in c.per_layer} <= set(names)


def test_kernel_names_data():
    from portbench import yardstick
    rooflines = [m["name"][:-len("_roofline")] for m in BENCH["per_layer"]
                 if m["name"].endswith("_roofline")]
    assert set(rooflines) <= set(yardstick.KERNELS)
    assert all(isinstance(v, list) and v for v in yardstick.KERNELS.values())
