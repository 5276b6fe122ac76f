"""The traffic generator: deterministic in the seed, the same work for
every seed of an open loop."""

import json

import numpy as np
import pytest

from conftest import ROOT

from portbench import traffic
from portbench.scene import Map

CFG = json.loads((ROOT / "portbench/configs/rooms-L.ehl20.f32.json")
                 .read_text())
M = Map(CFG["map"])
OPEN = {"loop": "open", "distribution": "uniform",
        "pairs_per_request": [1, 16], "rate_per_s": 1360}
CLOSED = json.loads((ROOT / "portbench/workloads/"
                     "ehl20-bf16.paths-uniform.json").read_text())


@pytest.mark.parametrize("spec", [OPEN, CLOSED], ids=["open", "closed"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, -3, 2 ** 40])
def test_same_seed_same_requests(spec, seed):
    a = traffic.make(spec, M, 0.2, traffic.rng(seed, traffic.TRAFFIC))
    b = traffic.make(spec, M, 0.2, traffic.rng(seed, traffic.TRAFFIC))
    c = traffic.make(spec, M, 0.2, traffic.rng(seed + 1, traffic.TRAFFIC))
    assert np.array_equal(a.s, b.s) and np.array_equal(a.t, b.t)
    assert np.array_equal(a.lo, b.lo)
    assert not np.array_equal(a.s[:8], c.s[:8])
    assert a.s.dtype == np.float32


def test_open_loop_same_work_in_another_order():
    a = traffic.make(OPEN, M, 1.0, traffic.rng(1, traffic.TRAFFIC))
    b = traffic.make(OPEN, M, 1.0, traffic.rng(2, traffic.TRAFFIC))
    assert a.n == b.n == round(OPEN["rate_per_s"])
    sa = np.diff(a.lo)
    sb = np.diff(b.lo)
    assert np.array_equal(np.sort(sa), np.sort(sb))
    assert not np.array_equal(sa, sb)
    lo, hi = OPEN["pairs_per_request"]
    assert sa.min() == lo and sa.max() == hi
    assert np.allclose(np.sort(np.diff(np.append(a.due, 1.0))),
                       np.sort(np.diff(np.append(b.due, 1.0))))
    assert a.due[0] == 0.0 and a.due[-1] < 1.0


def test_closed_loop_pool():
    r = traffic.make(CLOSED, M, 2.0, traffic.rng(9, traffic.TRAFFIC))
    assert r.n == int(np.ceil(CLOSED["max_requests_per_s"] * 2.0))
    assert set(np.diff(r.lo)) == {CLOSED["pairs_per_request"][0]}
