"""The yardstick of the per-layer metrics: peaks, work counts, trace reading.

Frozen here so that no change to the program moves its own yardstick.

* Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
  float32 outside the tensor cores and the HBM3 rate.  A card set below
  700 W runs slower; the run prints its limit beside every share.
* Work counts: the least work the visibility and join kernels must do for
  the queries a traced sub-window served, counted from those queries' own
  inputs.  Visibility: a segment that is clear of every obstacle needs all
  its pairs with the real edges tested, a blocked one at least one pair,
  whatever the order of the test; every distinct via of a query's region
  is one segment on each side, and the pair (s, t) one more.  Join: every
  real label of both regions read once (hub id and distance as the slab
  stores them) and the distance written once.
* ``kernels.json`` maps a kernel of the yardstick to the names of its
  device functions in the profiler, so that a renamed or added kernel is a
  change of data.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench.reference import Arith, blocked

F32_OPS_PER_S = 67e12          # float32, no tensor cores (an fma is 2 ops)
HBM_BYTES_PER_S = 3.35e12
#: operations of one (segment, edge) test of the visibility predicate, as
#: the port's cost model counted them when the benchmark was defined
SEGVIS_OPS_PER_PAIR = 34
#: bytes of one stored label that the join must read (hub id + distance)
LABEL_BYTES = {"f32": 4 + 4, "bf16": 2 + 2, "f16": 2 + 2}
#: bytes of one answer written (the distance)
ANSWER_BYTES = 4

KERNELS = json.loads((Path(__file__).parent / "kernels.json").read_text())


class RegionTable:
    """Per region of a host index: its distinct via corners and its real
    label count; per cell its region (the host index's own mapper)."""

    def __init__(self, index):
        V = index.graph.num_nodes
        self.nodes = np.asarray(index.graph.nodes, np.float64)
        self.cell_size, self.nx, self.ny = index.cell_size, index.nx, index.ny
        self.mapper = np.asarray(index.mapper, np.int64)
        self.vias = {rid: np.unique(r.keys % V)
                     for rid, r in index.regions.items()}
        self.labels = {rid: int(r.keys.size)
                       for rid, r in index.regions.items()}

    def region(self, pts: np.ndarray) -> np.ndarray:
        p = np.asarray(pts, np.float64)
        ix = np.minimum((p[:, 0] / self.cell_size).astype(np.int64),
                        self.nx - 1)
        iy = np.minimum((p[:, 1] / self.cell_size).astype(np.int64),
                        self.ny - 1)
        return self.mapper[iy * self.nx + ix]


def visibility_pairs(table: RegionTable, rects: np.ndarray, s: np.ndarray,
                     t: np.ndarray, device="cpu") -> int:
    """Least (segment, edge) pairs the visibility kernels test for the
    queries (s, t)."""
    ar = Arith("f64")
    dev = torch.device(device)
    R = ar.tensor(rects, dev)
    edges = 4 * len(rects)

    def count(p, q, block: int = 1 << 18) -> int:
        c = 0
        for lo in range(0, len(p), block):
            c += int((~blocked(ar.tensor(p[lo:lo + block], dev),
                               ar.tensor(q[lo:lo + block], dev), R,
                               ar)).sum())
        return c * edges + (len(p) - c)

    total = count(s, t)
    for pts in (s, t):
        regions = table.region(pts)
        for rid in np.unique(regions):
            vias = table.nodes[table.vias[int(rid)]]
            if not len(vias):
                continue
            p = pts[regions == rid]
            total += count(np.repeat(p, len(vias), axis=0),
                           np.tile(vias, (len(p), 1)))
    return total


def join_bytes(table: RegionTable, layout: str, s: np.ndarray,
               t: np.ndarray) -> int:
    """Least bytes the label join moves for the queries (s, t)."""
    n = sum(table.labels[int(r)] for pts in (s, t)
            for r in table.region(pts))
    return n * LABEL_BYTES[layout] + ANSWER_BYTES * len(s)


def bound_seconds(table: RegionTable, rects, layout: str, s, t,
                  device="cpu") -> dict:
    """{kernel: least seconds at the peaks} for the queries (s, t)."""
    return {"segvis": visibility_pairs(table, rects, s, t, device)
            * SEGVIS_OPS_PER_PAIR / F32_OPS_PER_S,
            "label_join_rowmin": join_bytes(table, layout, s, t)
            / HBM_BYTES_PER_S}


# ----------------------------------------------------------- trace reading
def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


class DeviceTrace:
    """What a ``torch.profiler`` window shows: seconds by device operation,
    the seconds in which any ran (overlaps counted once), and the idle
    gaps between them named by the innermost host operation open at the
    gap's middle ("python" where none was)."""

    def __init__(self, prof, window_s: float, gaps_named: int = 500):
        self.window_s = window_s
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            (dev if _is_device(e) else host).append((e.key, tr.start,
                                                     tr.end))
        self.ops: dict = {}
        for name, a, b in dev:
            self.ops[name] = self.ops.get(name, 0.0) + (b - a) * 1e-6
        self.busy_s, gaps = _union(dev)
        self.idle_gaps = _name_gaps(gaps, host, gaps_named)

    def kernel_seconds(self, kernel: str) -> float:
        pats = KERNELS[kernel]
        return sum(s for name, s in self.ops.items()
                   if any(p in name for p in pats))

    def top_ops(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.ops.items()),
                      key=lambda kv: -kv[1])[:n]


def _union(intervals) -> tuple:
    """(covered seconds, [(start_us, end_us)] gaps between covered runs)."""
    if not intervals:
        return 0.0, []
    iv = sorted((a, b) for _, a, b in intervals)
    busy, gaps = 0.0, []
    cur_a, cur_b = iv[0]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy * 1e-6, gaps


def _name_gaps(gaps, host, n: int) -> list:
    """[[host op, seconds]] of the ``n`` longest gaps, summed by name."""
    if not gaps:
        return []
    g = np.array(gaps, np.float64)
    g = g[np.argsort(g[:, 0] - g[:, 1])[:n]]
    mid = 0.5 * (g[:, 0] + g[:, 1])
    names = [h[0] for h in host]
    ha = np.array([h[1] for h in host], np.float64)
    hb = np.array([h[2] for h in host], np.float64)
    out: dict = {}
    for (a, b), m in zip(g, mid):
        open_ = np.flatnonzero((ha <= m) & (hb >= m)) if len(ha) else []
        name = "python" if not len(open_) else \
            names[int(open_[np.argmin(hb[open_] - ha[open_])])]
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:10]
