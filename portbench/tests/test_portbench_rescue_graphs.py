"""The reader of the rescue's graph replay counter, on synthetic contexts
and on traced tiny runs (CPU)."""

import json
from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench import harness

DATA = ROOT / "portbench"


def _ctx(deltas=None):
    deltas = deltas or {}
    return SimpleNamespace(traces=[],
                           delta=lambda name, **lbl: deltas.get(name, 0.0))


def test_rescue_graph_share_reads_the_counters():
    read = harness.load_metric(DATA, "rescue.graph_share").read
    assert read(_ctx({"rescue_batches_total": 40.0,
                      "rescue_graph_replays_total": 40.0})) == 1.0
    assert read(_ctx({"rescue_batches_total": 40.0,
                      "rescue_graph_replays_total": 30.0})) == 0.75
    # nothing rescued: nothing to share
    assert read(_ctx({"rescue_graph_replays_total": 0.0})) is None
    assert read(_ctx()) is None
    # rescues, none replayed: the eager rescue, or a program that does not
    # count the replays (the parent of the rescue graphs)
    assert read(_ctx({"rescue_batches_total": 40.0})) is None


def test_rescue_graph_share_is_declared_for_the_paths_cell():
    spec = harness.load_metric(DATA, "rescue.graph_share")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"]
                 if m["name"] == "rescue.graph_share")
    assert entry == {"name": spec.NAME, "unit": spec.UNIT,
                     "better": "higher", "source": spec.SOURCE,
                     "layer": spec.LAYER, "moves": spec.MOVES,
                     "workloads": ["ehl20-bf16.paths-uniform"]}
    assert bench["per_layer"][-1] is entry


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.paths"])
def test_traced_tiny_run_leaves_the_share_out(tiny_root, cell):
    res, _ = run_tiny(tiny_root, cell, trace=True, seconds=1.5)
    got = res["metrics"]
    assert res["correct"] is True
    # the CPU's artifact rescues eagerly: rescues counted, none replayed
    assert "rescue.graph_share" not in got
    if cell == "tiny.paths":
        assert got["rescue.ms_per_batch"]["value"] > 0
    else:
        assert "rescue.ms_per_batch" not in got
