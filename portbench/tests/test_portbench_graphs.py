"""The reader of the engine's graph replay counters, on synthetic contexts
and on traced tiny runs (CPU)."""

from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench import harness

DATA = ROOT / "portbench"


def _ctx(deltas=None):
    deltas = deltas or {}
    return SimpleNamespace(traces=[],
                           delta=lambda name, **lbl: deltas.get(name, 0.0))


def test_graph_replay_share_reads_the_counters():
    read = harness.load_metric(DATA, "engine.graph_replay_share").read
    assert read(_ctx({"graph_replays_total": 300.0})) == 1.0
    assert read(_ctx({"graph_replays_total": 300.0,
                      "graph_eager_calls_total": 100.0})) == 0.75
    assert read(_ctx({"graph_eager_calls_total": 7.0})) == 0.0
    # a program that counts neither (the parent of the graphs): nothing
    assert read(_ctx()) is None


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.paths"])
def test_traced_tiny_run_reports_the_eager_share(tiny_root, cell):
    res, _ = run_tiny(tiny_root, cell, trace=True, seconds=1.5)
    assert res["correct"] is True
    # the CPU's artifact serves eagerly: every device call counted, none
    # replayed
    assert res["metrics"]["engine.graph_replay_share"]["value"] == 0.0
