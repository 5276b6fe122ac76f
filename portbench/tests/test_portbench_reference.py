"""The reference against the port's host oracle, and its controls."""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT, make_tiny_root

from portbench.reference import Arith, Reference, blocked
from portbench.scene import CLEARANCE, Map, free_points


def _map(name: str, seed: int) -> Map:
    from repro_torch.core.maps import SUITES
    _, kw = SUITES[name]
    full = {"n_rooms": 14, "width": 100.0, "height": 100.0,
            "min_side": 5.0, "max_side": 22.0}
    full.update(kw)
    return Map({"generator": "rooms", "seed": seed, "params": full})


@pytest.mark.parametrize("name,seed", [("rooms-S", 0), ("rooms-S", 1),
                                       ("rooms-M", 0), ("rooms-L", 3)])
def test_frozen_rooms_equal_the_ports(name, seed):
    from repro_torch.core.geometry import Scene
    from repro_torch.core.maps import make_map
    m = _map(name, seed)
    port = make_map(name, seed)
    mine = Scene.build(m.polygons(), m.width, m.height)
    assert np.array_equal(mine.vertices, port.vertices)
    assert (m.width, m.height) == (port.width, port.height)


def test_reference_agrees_with_the_ports_host_oracle():
    from repro_torch.core.geometry import Scene
    from repro_torch.core.grid import build_ehl
    from repro_torch.core.query import query
    m = _map("rooms-S", 0)
    g = np.random.default_rng(5)
    s, t = free_points(m, 60, g), free_points(m, 60, g)
    d = Reference(m.rects).solve(s, t)
    idx = build_ehl(Scene.build(m.polygons(), m.width, m.height), 3.0)
    oracle = np.array([query(idx, a, b, want_path=False)[0]
                       for a, b in zip(s, t)])
    assert np.max(np.abs(oracle - d) / np.maximum(d, 1.0)) < 1e-9


def test_reference_polylines_have_its_lengths():
    m = _map("rooms-S", 1)
    g = np.random.default_rng(6)
    s, t = free_points(m, 40, g), free_points(m, 40, g)
    ref = Reference(m.rects)
    d, paths = ref.solve(s, t, want_paths=True)
    from portbench.reference.compare import path_gaps
    got = path_gaps(ref, s, t, paths, d)
    assert got["paths_invalid"] == 0 and got["path_len_rel_gap"] < 1e-12


def test_touching_does_not_block():
    ar = Arith("f64")
    r = torch.tensor([[1.0, 1.0, 2.0, 2.0]], dtype=torch.float64)
    seg = lambda a, b: blocked(torch.tensor(a, dtype=torch.float64),  # noqa
                               torch.tensor(b, dtype=torch.float64), r, ar)
    assert not seg([0.0, 1.0], [3.0, 1.0])       # slides along an edge
    assert not seg([0.0, 0.0], [1.0, 1.0])       # ends on a corner
    assert not seg([1.0, 3.0], [3.0, 1.0])       # grazes the corner (2, 2)
    assert seg([0.0, 1.5], [3.0, 1.5])           # crosses
    assert seg([1.0, 1.0], [2.0, 2.0])           # the diagonal


def test_free_points_keep_clear():
    m = _map("rooms-M", 0)
    p = free_points(m, 5000, np.random.default_rng(1)).astype(np.float64)
    r = m.rects
    inside = ((p[:, None, 0] > r[:, 0] - CLEARANCE)
              & (p[:, None, 0] < r[:, 2] + CLEARANCE)
              & (p[:, None, 1] > r[:, 1] - CLEARANCE)
              & (p[:, None, 1] < r[:, 3] + CLEARANCE))
    assert not inside.any()


@pytest.mark.parametrize("cell,layout", [("tiny.batch", "f32"),
                                         ("tiny.paths", "bf16")])
def test_control_comes_out_not_correct(tmp_path, cell, layout):
    """The control in the program's place: the f32 configuration's is the
    program's own bf16 slabs, the bf16 one's the reference in fp8.  Some
    number of the check exceeds its limit."""
    from portbench import harness
    from portbench.control import (control_checks, program_checks,
                                   program_control)
    root = make_tiny_root(tmp_path, layout)
    c = harness.load_cell(cell, root)
    kind = c.config["control"]["kind"]
    assert kind == {"f32": "program", "bf16": "reference"}[layout]
    for seed in (1, 2, 3):
        if kind == "program":
            checks, _ = program_checks(program_control(c), seed, 1.0, "cpu")
        else:
            checks = control_checks(c, seed, 2.0, "cpu")
        assert any(v > lim for _, v, lim in checks), checks


def test_limits_sit_between_readings():
    """Each continuous limit sits between the readings PERF.md gives it."""
    for name in ("rooms-L.ehl20.f32", "rooms-L.ehl20.bf16u16"):
        cfg = json.loads((ROOT / "portbench/configs" / f"{name}.json")
                         .read_text())
        for k, lim in cfg["limits"].items():
            if k in ("paths_invalid", "missing"):
                assert lim == 0
            else:
                assert 1e-6 < lim < 1e-1
