"""The check catches a broken timed path: each fault the cells can have
comes out ``correct`` false, with everything but the look for a chip run as
in a real run (on the CPU, at a tiny size)."""

import json

import numpy as np
import pytest

from conftest import make_tiny_root, run_tiny

from repro_torch.serving import engine as serving_engine
from repro_torch.serving.query_engine import DeviceEngine


def _half_left_out(orig):
    def batch(self, s, t, bucket=0):
        out = orig(self, s, t, bucket)
        out = [np.array(o) for o in (out if isinstance(out, tuple)
                                     else (out,))]
        for o in out:
            o[len(o) // 2:] = 0
        return tuple(out) if len(out) > 1 else out[0]
    return batch


def _altered(orig):
    def batch(self, s, t, bucket=0):
        out = np.array(orig(self, s, t, bucket))
        out[0] = out[0] * 1.05 + 1.0
        return out
    return batch


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_half_the_batch_left_out(tmp_path, monkeypatch, layout):
    root = make_tiny_root(tmp_path, layout)
    monkeypatch.setattr(DeviceEngine, "batch",
                        _half_left_out(DeviceEngine.batch))
    res, _ = run_tiny(root, "tiny.batch")
    assert res["correct"] is False


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_an_answer_altered(tmp_path, monkeypatch, layout):
    root = make_tiny_root(tmp_path, layout)
    monkeypatch.setattr(DeviceEngine, "batch", _altered(DeviceEngine.batch))
    res, _ = run_tiny(root, "tiny.batch")
    assert res["correct"] is False


def test_argmin_half_left_out(tiny_root, monkeypatch):
    monkeypatch.setattr(DeviceEngine, "batch_argmin",
                        _half_left_out(DeviceEngine.batch_argmin))
    res, _ = run_tiny(tiny_root, "tiny.paths")
    assert res["correct"] is False


def test_a_polyline_altered(tiny_root, monkeypatch):
    orig = serving_engine.unwind_path

    def unwind(index, s, t, via_s, hub, via_t):
        p = orig(index, s, t, via_s, hub, via_t)
        return p[:1] + p[2:] if len(p) > 2 else p   # a corner left out
    monkeypatch.setattr(serving_engine, "unwind_path", unwind)
    res, _ = run_tiny(tiny_root, "tiny.paths")
    assert res["correct"] is False
    assert res["checks"]["paths_invalid"]["value"] > 0


def test_an_answer_never_comes(tiny_root, monkeypatch):
    from portbench import harness
    from repro_torch.serving.batcher import Ticket
    monkeypatch.setattr(harness, "LATE_S", 0.5)
    orig = Ticket._write

    def write(self, slots, cols):
        if self.n == 1:             # one-pair requests are never answered
            return
        orig(self, slots, cols)
    monkeypatch.setattr(Ticket, "_write", write)
    res, _ = run_tiny(tiny_root, "tiny.open")
    assert res["correct"] is False and res["failed"] > 0


def test_the_rescue_left_out(tmp_path, monkeypatch):
    """The bf16 slabs' ambiguous rows keep their quantized winners: a
    polyline through a near-tie's wrong hub is longer than the shortest."""
    from portbench import control
    root = make_tiny_root(tmp_path, "bf16")
    wl = root / "portbench/workloads/tiny.paths.json"
    spec = json.loads(wl.read_text())
    spec.update(check_pairs=2048, check_paths=2048, keep_every=1)
    wl.write_text(json.dumps(spec))
    with control.planted("no-rescue"):
        res, _ = run_tiny(root, "tiny.paths")
    assert res["correct"] is False
    assert res["checks"]["path_len_rel_gap"]["value"] > \
        res["checks"]["path_len_rel_gap"]["limit"]
