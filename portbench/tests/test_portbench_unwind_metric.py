"""The reader of the host unwind's chain table counters, on synthetic
contexts and on a traced tiny run (CPU)."""

from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench import harness

DATA = ROOT / "portbench"


def _ctx(deltas=None):
    deltas = deltas or {}
    return SimpleNamespace(traces=[],
                           delta=lambda name, **lbl: deltas.get(name, 0.0))


def test_chain_hit_share_reads_the_counters():
    read = harness.load_metric(DATA, "unwind.chain_hit_share").read
    assert read(_ctx({"unwind_rows_total": 500.0,
                      "unwind_chain_fills_total": 10.0})) == \
        pytest.approx(1 - 10 / 1000)
    assert read(_ctx({"unwind_rows_total": 500.0})) == 1.0
    # every chain of every row walked from the labels
    assert read(_ctx({"unwind_rows_total": 3.0,
                      "unwind_chain_fills_total": 6.0})) == 0.0


def test_chain_hit_share_without_rows_is_none():
    read = harness.load_metric(DATA, "unwind.chain_hit_share").read
    # a program without the table (the parent of the table), or no row
    # unwound in the window: nothing to read
    assert read(_ctx()) is None
    assert read(_ctx({"unwind_chain_fills_total": 4.0})) is None


def test_traced_tiny_run_reports_the_hit_share(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny.paths", trace=True, seconds=1.5)
    assert res["correct"] is True
    assert 0 < res["metrics"]["unwind.chain_hit_share"]["value"] <= 1
