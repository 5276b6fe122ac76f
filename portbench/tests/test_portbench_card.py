"""On the card (``python -m pytest -q -m cuda portbench/tests``): one
short run of each cell through ``run.py``, correct and on the GPU."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", cell, "--seed", "2147483999",
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
