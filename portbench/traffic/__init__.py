"""The one traffic generator: requests of (s, t) pairs made from the seed.

A cell's workload file (``portbench/workloads/<cell>.json``) holds the
parameters; nothing here knows a cell by name.

Endpoints are drawn by ``"distribution"``:

* ``"uniform"`` — uniform over free space.
* ``"cluster"`` — the paper's Cluster-k, mixed with uniform pairs as its
  Mixed-y deviation workload (Table 6): ``round(adherence * n)`` of the
  ``n`` pairs, at places drawn from the seed, take s and t from two
  independently drawn hot spots (which may be one), each uniform over the
  free part of its rectangle; the rest are uniform.  The hot spots are the
  deployment's: ``clusters`` (``k``, ``side_frac``, ``seed``) comes from the
  cell's configuration (``harness.load_cell`` hands it over), and its
  rectangles from the configuration's ``seed``, never the run's.

* ``"loop": "closed"`` — one client sends a request, waits for its answer,
  sends the next.  Every request has ``pairs_per_request[0]`` to ``[1]``
  pairs, endpoints uniform over free space.  The pool holds
  ``max_requests_per_s`` times the window's seconds distinct requests
  (drawn up front, as set-up), used in turn.
* ``"loop": "open"`` — requests fall due on a fixed schedule whether or not
  earlier ones were answered.  The window holds ``round(rate_per_s *
  seconds)`` requests.  Every seed gets the same work in another order:
  the pair counts are an equal share of each count in
  ``pairs_per_request``, and the gaps are the quantiles of the exponential
  distribution at ``rate_per_s`` (Poisson arrivals), both permuted by the
  seed, the gaps scaled to fill the window exactly.

``seed`` may be any whole number; streams of one seed are independent:
``rng(seed, 0)`` the window's traffic, ``rng(seed, 1)`` the warm-up's,
``rng(seed, 2)`` the sample the reference checks; ``rng(seed, 3)`` of a
configuration's cluster seed places its hot spots, ``rng(seed, 4)`` of its
history seed draws the history that scores a workload-aware index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.scene import Map, free_points, near_obstacle

TRAFFIC, WARMUP, SAMPLE, CLUSTERS, HISTORY = 0, 1, 2, 3, 4
#: uniform probes of a candidate hot spot, and how many must be free for
#: it to count as holding free space (as the port's ``make_clusters``)
PROBES, PROBES_FREE = 64, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


@dataclasses.dataclass
class Requests:
    """``n`` requests: request ``i`` is pairs ``lo[i]:lo[i + 1]`` of
    ``s``/``t``; ``due`` (open loop) its offset in seconds from the start
    of the window."""

    s: np.ndarray
    t: np.ndarray
    lo: np.ndarray
    due: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.lo) - 1

    def pairs(self, i: int) -> tuple:
        a, b = self.lo[i], self.lo[i + 1]
        return self.s[a:b], self.t[a:b]

    def size(self, i: int) -> int:
        return int(self.lo[i + 1] - self.lo[i])


def _sizes(spec: dict, n: int, g: np.random.Generator) -> np.ndarray:
    a, b = spec["pairs_per_request"]
    counts = a + np.arange(n) % (b - a + 1)
    return g.permutation(counts)


def cluster_rects(m: Map, clusters: dict) -> np.ndarray:
    """[k, 4] float64 hot spots (x0, y0, x1, y1): axis-aligned rectangles
    with sides ``side_frac`` of the map's extent, each centred on a free
    point (moved inside the map where it would overhang) and kept only
    where :data:`PROBES_FREE` of :data:`PROBES` uniform probes are free."""
    g = rng(clusters["seed"], CLUSTERS)
    sw = clusters["side_frac"] * m.width
    sh = clusters["side_frac"] * m.height
    rects = []
    for _ in range(1000 * clusters["k"]):
        if len(rects) == clusters["k"]:
            break
        cx, cy = free_points(m, 1, g)[0]
        x0 = min(max(cx - sw / 2, 0.0), m.width - sw)
        y0 = min(max(cy - sh / 2, 0.0), m.height - sh)
        x = g.uniform(x0, x0 + sw, PROBES).astype(np.float32)
        y = g.uniform(y0, y0 + sh, PROBES).astype(np.float32)
        if np.count_nonzero(~near_obstacle(m, x, y)) >= PROBES_FREE:
            rects.append((x0, y0, x0 + sw, y0 + sh))
    if len(rects) < clusters["k"]:
        raise ValueError(f"only {len(rects)} of {clusters['k']} hot spots "
                         "hold free space")
    return np.array(rects, np.float64)


def cluster_points(m: Map, rects: np.ndarray, which: np.ndarray,
                   g: np.random.Generator) -> np.ndarray:
    """[n, 2] float32 points, point ``i`` uniform over the free part of
    ``rects[which[i]]``, each at least ``CLEARANCE`` from every obstacle."""
    out = np.empty((len(which), 2), np.float32)
    todo = np.arange(len(which))
    while len(todo):
        r = rects[which[todo]]
        x = g.uniform(r[:, 0], r[:, 2]).astype(np.float32)
        y = g.uniform(r[:, 1], r[:, 3]).astype(np.float32)
        free = ~near_obstacle(m, x, y)
        out[todo[free], 0] = x[free]
        out[todo[free], 1] = y[free]
        todo = todo[~free]
    return out


def endpoints(spec: dict, m: Map, n: int, g: np.random.Generator) -> tuple:
    """([n, 2], [n, 2]) float32 endpoints s and t of ``n`` pairs drawn by
    ``spec["distribution"]``."""
    if spec["distribution"] == "uniform":
        return free_points(m, n, g), free_points(m, n, g)
    if spec["distribution"] != "cluster":
        raise ValueError(f"unknown query distribution "
                         f"{spec['distribution']!r} (uniform, cluster)")
    if "clusters" not in spec:
        raise ValueError("cluster traffic needs the configuration's "
                         "\"clusters\"")
    rects = cluster_rects(m, spec["clusters"])
    hot = g.permutation(n) < round(spec["adherence"] * n)
    s = np.empty((n, 2), np.float32)
    t = np.empty((n, 2), np.float32)
    cold = int(n - hot.sum())
    s[~hot] = free_points(m, cold, g)
    t[~hot] = free_points(m, cold, g)
    k = len(rects)
    s[hot] = cluster_points(m, rects, g.integers(0, k, n - cold), g)
    t[hot] = cluster_points(m, rects, g.integers(0, k, n - cold), g)
    return s, t


def _fill(spec: dict, m: Map, sizes: np.ndarray, g: np.random.Generator,
          due=None):
    s, t = endpoints(spec, m, int(sizes.sum()), g)
    lo = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return Requests(s, t, lo, due)


def closed(spec: dict, m: Map, seconds: float, g: np.random.Generator
           ) -> Requests:
    n = max(1, math.ceil(spec["max_requests_per_s"] * seconds))
    return _fill(spec, m, _sizes(spec, n, g), g)


def open_schedule(spec: dict, m: Map, seconds: float, g: np.random.Generator,
                  rate: float | None = None) -> Requests:
    rate = float(spec["rate_per_s"] if rate is None else rate)
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = g.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return _fill(spec, m, _sizes(spec, n, g), g, due)


def make(spec: dict, m: Map, seconds: float, g: np.random.Generator,
         rate: float | None = None) -> Requests:
    """The requests of one window of ``seconds`` under ``spec``."""
    if spec["loop"] == "closed":
        return closed(spec, m, seconds, g)
    if spec["loop"] == "open":
        return open_schedule(spec, m, seconds, g, rate)
    raise ValueError(f"unknown loop {spec['loop']!r}")
