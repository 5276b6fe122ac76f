"""The result line of a run, on the CPU at a tiny size."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny.batch", "tiny.paths", "tiny.open"])
def test_untraced_line(tiny_root, cell):
    res, checks = run_tiny(tiny_root, cell)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"qps", "p95_ms", "peak_mem_mib",
                                    "setup_s"}
    units = {"qps": "queries/s", "p95_ms": "ms", "peak_mem_mib": "MiB",
             "setup_s": "s"}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and isinstance(v["value"], float)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert [(n, c["value"], c["limit"]) for n, c in line["checks"].items()] \
        == [(n, v, lim) for n, v, lim in checks]


def test_traced_line(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny.paths", trace=True, seconds=1.5)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    got = set(res["metrics"])
    # what the CPU can read: no device trace, so no roofline or idle share
    assert {"setup.index_s", "index.device_mib", "route.us_per_query",
            "dispatch.us_per_query", "rescue.ms_per_batch",
            "unwind.us_per_query"} <= got
    assert not any(n.endswith("_roofline") or n.startswith("device.")
                   for n in got)


def test_no_card_no_result(tmp_path):
    """run.py refuses without a CUDA device and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", "ehl20-f32.batch-uniform", "--seed",
                        "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
