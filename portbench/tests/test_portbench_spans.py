"""The readers of the dispatch's child spans and of the rescue's row
counters, on synthetic contexts and on traced tiny runs (CPU)."""

from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench import harness

DATA = ROOT / "portbench"
SPAN_METRICS = {"dispatch.assemble_us_per_query": ("batch.assemble",
                                                   "batch.scatter"),
                "engine.upload_us_per_query": ("engine.upload",),
                "engine.launch_us_per_query": ("engine.launch",),
                "engine.readback_us_per_query": ("engine.readback",)}


def _span(name, seconds):
    return SimpleNamespace(name=name, seconds=seconds)


def _trace(n, spans=None, kind="sync"):
    t = SimpleNamespace(kind=kind, attrs={"n": n}, stages={"dispatch": 1.0})
    if spans is not None:
        t.spans = spans
    return t


def _ctx(traces=(), deltas=None):
    deltas = deltas or {}
    return SimpleNamespace(traces=list(traces),
                           delta=lambda name, **lbl: deltas.get(name, 0.0))


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_sums_its_spans_over_queries(metric):
    read = harness.load_metric(DATA, metric).read
    names = SPAN_METRICS[metric]
    spans = [_span(names[0], 3e-6), _span("engine.other", 50e-6),
             _span(names[-1], 5e-6)]
    want = 1e6 * (3e-6 + 5e-6) / 40    # both ends' spans, 40 sync queries
    got = read(_ctx([_trace(30, spans), _trace(10, []),
                     _trace(99, [_span(names[0], 1.0)], kind="async")]))
    assert got == pytest.approx(want)
    # a program without child spans, or no sync trace: nothing to read
    assert read(_ctx([_trace(30), _trace(10)])) is None
    assert read(_ctx([_trace(30, [_span("engine.other", 1e-6)])])) is None
    assert read(_ctx()) is None


def test_rescue_rows_share_reads_the_counters():
    read = harness.load_metric(DATA, "rescue.rows_share").read
    assert read(_ctx(deltas={"argmin_rows_total": 2560.0,
                             "rescue_rows_total": 1183.0})) == \
        pytest.approx(1183 / 2560)
    assert read(_ctx(deltas={"argmin_rows_total": 512.0})) == 0.0
    assert read(_ctx(deltas={"rescue_rows_total": 3.0})) is None
    assert read(_ctx()) is None


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.paths"])
def test_traced_tiny_run_reports_the_new_metrics(tiny_root, cell):
    res, _ = run_tiny(tiny_root, cell, trace=True, seconds=1.5)
    got = res["metrics"]
    assert res["correct"] is True
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, name
    dispatch = got["dispatch.us_per_query"]["value"]
    children = sum(got[name]["value"] for name in SPAN_METRICS)
    assert children <= dispatch
    if cell == "tiny.paths":        # the bf16 tiny map rescues some rows
        assert 0 < got["rescue.rows_share"]["value"] <= 1
    else:
        assert "rescue.rows_share" not in got
