"""Fixtures of the benchmark's own tests (run them with
``python -m pytest -q portbench/tests`` from the root of the repo).

``tiny_root`` is a copy of the benchmark's files in a temporary checkout
with three small cells (``tiny.batch``, ``tiny.paths``, ``tiny.open``) on a
four-room map, which the harness runs on the CPU (the kernels' plain
twins).  ``cuda`` is the repo's marker for tests that need the card; they
skip here through the ``card`` fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = (("tiny.batch", "query", "closed"),
              ("tiny.paths", "query_paths", "closed"),
              ("tiny.open", "submit", "open"))


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")


def make_tiny_root(root: Path, layout: str = "bf16") -> Path:
    """A checkout holding the benchmark's files and the tiny cells."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__",
                                                  "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = "rooms-L.ehl20.bf16u16" if layout == "bf16" else \
        "rooms-L.ehl20.f32"
    cfg = json.loads((ROOT / "portbench/configs" / f"{base}.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["map"]["params"].update(n_rooms=4, width=30.0, height=30.0)
    cfg["batch"] = 32
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    for name, entry, loop in TINY_CELLS:
        wl = {"name": name, "config": "tiny", "traffic": name.split(".")[1],
              "loop": loop, "entry": entry, "distribution": "uniform",
              "pairs_per_request": [48, 64] if loop == "closed" else [1, 4],
              "max_requests_per_s": 40, "check_pairs": 256,
              "check_paths": 128, "keep_every": 2, "rate_per_s": 100,
              "latency_limit_ms": 100.0,
              "batcher": {"max_wait_ms": 2.0, "depth": 2, "policy": "shed",
                          "max_queue": 8192},
              "why": "test"}
        (root / "portbench/workloads" / f"{name}.json").write_text(
            json.dumps(wl))
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": wl["traffic"], "chips": 1,
                                   "why": "test"})
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"] += [name for name, _, _ in TINY_CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def run_tiny(root: Path, cell: str, seed: int = 3, seconds: float = 1.0,
             trace: bool = False):
    import time

    from portbench import harness
    return harness.run(harness.load_cell(cell, root), seed, seconds, trace,
                       time.perf_counter(), device="cpu")
