"""Query workloads — paper §Experiments.

* ``Unknown``: uniform random free-space pairs (stands in for the MovingAI
  scenario files).
* ``Cluster-x``: x rectangular clusters, side = 10% of map extent, random
  centers in traversable space, each cluster reachable from at least one
  other; queries pick s and t from (possibly different) clusters.
* ``historical_workload``: per-cell counts w_c from a history sample — the
  score initialisation ``s(c) = 1 + w_c`` of workload-aware EHL*.

The generators draw the same points from the same seed as the reference's
``repro.core.workload``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geometry import Scene, points_strictly_inside, random_free_points
from .grid import EHLIndex
from .visgraph import VisGraph, astar


@dataclasses.dataclass
class QuerySet:
    name: str
    s: np.ndarray     # [N,2]
    t: np.ndarray     # [N,2]


def _free_points_in_rect(scene: Scene, rect, n, rng,
                         strict: bool = True) -> np.ndarray:
    """Rejection-sample ``n`` free-space points inside ``rect``.

    ``strict=True`` (default) raises if the rect cannot yield ``n`` free
    points after 200 sampling rounds.  ``strict=False`` is the probing mode
    (``make_clusters`` testing whether a candidate rect has enough free
    space at all).
    """
    x0, y0, x1, y1 = rect
    out = np.zeros((n, 2))
    got = 0
    tries = 0
    while got < n and tries < 200:
        tries += 1
        cand = rng.uniform([x0, y0], [x1, y1], size=(max(32, 2 * (n - got)), 2))
        keep = cand[~points_strictly_inside(scene, cand)]
        take = min(len(keep), n - got)
        out[got:got + take] = keep[:take]
        got += take
    if got < n and strict:
        raise RuntimeError(
            f"only {got}/{n} free points found in rect "
            f"({x0:.2f},{y0:.2f})-({x1:.2f},{y1:.2f}) after 200 sampling "
            "rounds — the rect is (almost) fully covered by obstacles; "
            "pick a different cluster rect or pass strict=False to probe")
    return out[:got]


def make_clusters(scene: Scene, k: int, rng: np.random.Generator,
                  side_frac: float = 0.10) -> list:
    """k cluster rectangles with centers in traversable space."""
    w, h = scene.width, scene.height
    sw, sh = side_frac * w, side_frac * h
    rects = []
    while len(rects) < k:
        c = random_free_points(scene, 1, rng)[0]
        x0 = min(max(c[0] - sw / 2, 0.0), w - sw)
        y0 = min(max(c[1] - sh / 2, 0.0), h - sh)
        rect = (x0, y0, x0 + sw, y0 + sh)
        if len(_free_points_in_rect(scene, rect, 4, rng, strict=False)) >= 4:
            rects.append(rect)
    return rects


def cluster_queries(scene: Scene, graph: VisGraph, k: int, n: int,
                    seed: int = 0, require_path: bool = True) -> QuerySet:
    """Cluster-k query set (paper's synthetic known-distribution workload)."""
    rng = np.random.default_rng(seed)
    rects = make_clusters(scene, k, rng)
    S, T = [], []
    guard = 0
    while len(S) < n and guard < 50 * n:
        guard += 1
        ra, rb = rng.integers(0, k, size=2)
        # rects are pre-validated by make_clusters to contain free points,
        # so strict sampling raising here is a real error, not bad luck
        ps = _free_points_in_rect(scene, rects[ra], 1, rng)
        pt = _free_points_in_rect(scene, rects[rb], 1, rng)
        if require_path:
            d, _ = astar(graph, ps[0], pt[0])
            if not np.isfinite(d):
                continue
        S.append(ps[0])
        T.append(pt[0])
    return QuerySet(name=f"Cluster-{k}", s=np.array(S), t=np.array(T))


def uniform_queries(scene: Scene, graph: VisGraph, n: int, seed: int = 0,
                    require_path: bool = True) -> QuerySet:
    rng = np.random.default_rng(seed)
    S, T = [], []
    guard = 0
    while len(S) < n and guard < 50 * n:
        guard += 1
        p = random_free_points(scene, 2, rng)
        if require_path:
            d, _ = astar(graph, p[0], p[1])
            if not np.isfinite(d):
                continue
        S.append(p[0])
        T.append(p[1])
    return QuerySet(name="Unknown", s=np.array(S), t=np.array(T))


def mixed_queries(cluster_qs: QuerySet, uniform_qs: QuerySet,
                  adherence: float, seed: int = 0) -> QuerySet:
    """Deviation workload (Table 6): y% cluster queries, rest uniform."""
    rng = np.random.default_rng(seed)
    n = min(len(cluster_qs.s), len(uniform_qs.s))
    pick = rng.random(n) < adherence
    s = np.where(pick[:, None], cluster_qs.s[:n], uniform_qs.s[:n])
    t = np.where(pick[:, None], cluster_qs.t[:n], uniform_qs.t[:n])
    return QuerySet(name=f"Mixed-{int(adherence * 100)}", s=s, t=t)


def historical_workload(index: EHLIndex, qs: QuerySet) -> np.ndarray:
    """Per-cell workload w_c = # historical queries with s or t in c."""
    w = np.zeros(index.nx * index.ny, dtype=np.float64)
    for p in np.concatenate([qs.s, qs.t]):
        w[index.cell_of_point(p)] += 1.0
    return w


def workload_scores(index: EHLIndex, qs: QuerySet) -> np.ndarray:
    """Paper's workload-aware initialisation: s(c) = 1 + w_c."""
    return 1.0 + historical_workload(index, qs)
