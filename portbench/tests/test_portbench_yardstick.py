"""The yardstick's frozen constants and counts, against hand counts."""

import numpy as np
import pytest

from portbench import yardstick
from portbench.yardstick import _name_gaps, _union


class _Table:
    """A region table of one region holding vias 0 and 1 with 5 labels."""

    def __init__(self):
        self.nodes = np.array([[0.0, 0.0], [10.0, 0.0]])
        self.vias = {0: np.array([0, 1])}
        self.labels = {0: 5}

    def region(self, pts):
        return np.zeros(len(pts), np.int64)


def test_frozen_constants():
    # the port's cost model when the benchmark was defined: 6 + 8 + 4 * 5
    assert yardstick.SEGVIS_OPS_PER_PAIR == 34
    assert yardstick.F32_OPS_PER_S == 67e12
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.LABEL_BYTES == {"f32": 8, "bf16": 4, "f16": 4}


def test_visibility_pairs_by_hand():
    rects = np.array([[4.0, -1.0, 6.0, 1.0]])      # between the two vias
    s = np.array([[0.0, 5.0]])
    t = np.array([[10.0, 5.0]])
    # s-t clear (4 edges); s sees via 0 (4), via 1 is behind the box? no:
    # s=(0,5) to (10,0) passes y=2.5..1.5 over x in 4..6: clear (4); t the same
    got = yardstick.visibility_pairs(_Table(), rects, s, t)
    assert got == 4 + 4 + 4 + 4 + 4
    s2 = np.array([[0.0, 0.0]])                    # via 1 blocked from here
    got2 = yardstick.visibility_pairs(_Table(), rects, s2, t)
    # s2-t: clear (4); s2: via 0 is itself (4), via 1 blocked (1); t: 4 + 4
    assert got2 == 4 + 4 + 1 + 4 + 4


def test_join_bytes_by_hand():
    s = np.zeros((3, 2))
    assert yardstick.join_bytes(_Table(), "f32", s, s) == 3 * 10 * 8 + 12
    assert yardstick.join_bytes(_Table(), "bf16", s, s) == 3 * 10 * 4 + 12


def test_union_and_gaps():
    busy, gaps = _union([("a", 0, 10), ("b", 5, 20), ("c", 30, 40)])
    assert busy == pytest.approx(30e-6) and gaps == [(20, 30)]
    host = [("outer", 0, 100), ("inner", 22, 28)]
    assert _name_gaps(gaps, host, 10) == [["inner", pytest.approx(10e-6)]]
    assert _name_gaps([(50, 60)], [("x", 0, 10)], 10) == [
        ["python", pytest.approx(10e-6)]]
