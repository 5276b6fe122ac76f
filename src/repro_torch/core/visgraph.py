"""Visibility graph over convex obstacle vertices + exact ground truth.

The visibility graph G=(V,E) has a node per convex obstacle vertex and an
edge between every co-visible pair, weighted by Euclidean distance.  The
classic ESPP reduction: every optimal obstacle-avoiding path is a path in G
augmented with s and t.  ``astar`` on the augmented graph is this repo's
ground-truth oracle (and the stand-in online competitor a la Polyanya in the
benchmark tables).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .geometry import Scene, edist, visible_batch, visible_from_point


@dataclasses.dataclass
class VisGraph:
    scene: Scene
    nodes: np.ndarray        # [V,2] convex-vertex coordinates
    adj_idx: list            # V lists of neighbour node ids
    adj_w: list              # V lists of edge weights

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return sum(len(a) for a in self.adj_idx) // 2


def build_visgraph(scene: Scene, chunk: int = 4096) -> VisGraph:
    """All-pairs co-visibility among convex vertices (vectorized, chunked)."""
    nodes = scene.convex_vertices
    V = len(nodes)
    adj_idx = [[] for _ in range(V)]
    adj_w = [[] for _ in range(V)]
    if V >= 2:
        iu, ju = np.triu_indices(V, k=1)
        P = nodes[iu]
        Q = nodes[ju]
        vis = visible_batch(scene, P, Q, chunk=chunk)
        w = edist(P, Q)
        for i, j, ok, d in zip(iu, ju, vis, w):
            if ok and d > 0:
                adj_idx[i].append(int(j))
                adj_w[i].append(float(d))
                adj_idx[j].append(int(i))
                adj_w[j].append(float(d))
    return VisGraph(scene, nodes, adj_idx, adj_w)


def dijkstra(g: VisGraph, src: int) -> tuple[np.ndarray, np.ndarray]:
    """Single-source distances + predecessor array over the visgraph."""
    V = g.num_nodes
    dist = np.full(V, np.inf)
    pred = np.full(V, -1, dtype=np.int64)
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u] + 1e-12:
            continue
        for v, w in zip(g.adj_idx[u], g.adj_w[u]):
            nd = d + w
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                pred[v] = u
                heapq.heappush(pq, (nd, v))
    return dist, pred


def astar(g: VisGraph, s: np.ndarray, t: np.ndarray
          ) -> tuple[float, list[np.ndarray]]:
    """Exact ESPP oracle: A* over the s/t-augmented visibility graph.

    Returns (distance, path points).  distance = inf when unreachable.
    """
    s = np.asarray(s, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    scene = g.scene
    if visible_batch(scene, s[None], t[None])[0]:
        return float(edist(s, t)), [s, t]
    V = g.num_nodes
    svis = visible_from_point(scene, s, g.nodes) if V else np.zeros(0, bool)
    tvis = visible_from_point(scene, t, g.nodes) if V else np.zeros(0, bool)
    if not svis.any() or not tvis.any():
        return float("inf"), []

    h = edist(g.nodes, t[None])                  # admissible heuristic
    dist = np.full(V, np.inf)
    pred = np.full(V, -2, dtype=np.int64)        # -1 marks source
    pq = []
    for i in np.nonzero(svis)[0]:
        d = float(edist(s, g.nodes[i]))
        if d < dist[i]:
            dist[i] = d
            pred[i] = -1
            heapq.heappush(pq, (d + h[i], d, int(i)))
    t_edge = {int(i): float(edist(g.nodes[i], t)) for i in np.nonzero(tvis)[0]}
    best = np.inf
    best_end = -1
    while pq:
        f, d, u = heapq.heappop(pq)
        if d > dist[u] + 1e-12 or f >= best - 1e-12:
            continue
        if u in t_edge and d + t_edge[u] < best:
            best = d + t_edge[u]
            best_end = u
        for v, w in zip(g.adj_idx[u], g.adj_w[u]):
            nd = d + w
            if nd < dist[v] - 1e-12:
                dist[v] = nd
                pred[v] = u
                heapq.heappush(pq, (nd + h[v], nd, v))
    if not np.isfinite(best):
        return float("inf"), []
    path = [t]
    u = best_end
    while u != -1:
        path.append(g.nodes[u])
        u = int(pred[u])
    path.append(s)
    return float(best), path[::-1]
