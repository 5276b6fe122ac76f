"""Hub labeling (2-hop cover) on the visibility graph.

Pruned Landmark Labeling (Akiba et al. 2013) adapted to real-weighted graphs:
process vertices in importance order; for hub ``h`` run a pruned Dijkstra —
when a vertex ``u`` pops at distance ``d`` and the *current* labels already
certify ``dist(h,u) <= d``, prune the branch; otherwise record label
``(h, d, next_hop)`` where ``next_hop`` is u's neighbour toward ``h`` (for
path unwinding, as in the EHL paper).  The canonical ordering guarantees the
2-hop *coverage property* used by Eq.(1) of the paper.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .visgraph import VisGraph


@dataclasses.dataclass
class HubLabels:
    """Per-vertex sorted label arrays.

    labels[v] = (hubs [k] int64 ascending, dists [k] float64, nexthop [k] int64)
    ``nexthop`` is the neighbour of v that is next on the shortest path from v
    toward the hub (== v itself when v is the hub).
    """

    order: np.ndarray                 # importance order (hub rank -> vertex)
    labels: list

    def label_count(self) -> int:
        return sum(len(h) for (h, _, _) in self.labels)

    def avg_label_size(self) -> float:
        return self.label_count() / max(1, len(self.labels))

    def query(self, a: int, b: int) -> float:
        """Eq.(1): min over common hubs of d(a,h)+d(h,b)."""
        ha, da, _ = self.labels[a]
        hb, db, _ = self.labels[b]
        i = j = 0
        best = np.inf
        while i < len(ha) and j < len(hb):
            if ha[i] == hb[j]:
                s = da[i] + db[j]
                if s < best:
                    best = s
                i += 1
                j += 1
            elif ha[i] < hb[j]:
                i += 1
            else:
                j += 1
        return float(best)

    def unwind(self, v: int, hub: int) -> list[int]:
        """Vertex sequence from v to hub following next-hop pointers."""
        path = [v]
        cur = v
        guard = 0
        while cur != hub:
            hs, _, nh = self.labels[cur]
            k = np.searchsorted(hs, hub)
            if k >= len(hs) or hs[k] != hub:
                raise KeyError(f"hub {hub} not in labels of {cur}")
            cur = int(nh[k])
            path.append(cur)
            guard += 1
            if guard > len(self.labels) + 1:
                raise RuntimeError("next-hop cycle")
        return path


def build_hub_labels(g: VisGraph, order: np.ndarray | None = None) -> HubLabels:
    """Pruned landmark labeling; default order = degree desc (ties by id)."""
    V = g.num_nodes
    if order is None:
        deg = np.array([len(a) for a in g.adj_idx])
        order = np.lexsort((np.arange(V), -deg))
    rank = np.empty(V, dtype=np.int64)
    rank[order] = np.arange(V)

    tmp: list[list[tuple[int, float, int]]] = [[] for _ in range(V)]
    # fast pruning query: for each vertex keep dict hub->dist
    lab_dict: list[dict[int, float]] = [dict() for _ in range(V)]

    dist = np.full(V, np.inf)
    touched: list[int] = []
    for hub in order:
        hub = int(hub)
        hub_labs = lab_dict[hub]
        pq = [(0.0, hub, hub)]   # (dist, vertex, next_hop_toward_hub)
        dist[hub] = 0.0
        touched.append(hub)
        settled = set()
        while pq:
            d, u, nh = heapq.heappop(pq)
            if u in settled or d > dist[u] + 1e-12:
                continue
            settled.add(u)
            # prune: existing labels already cover (hub, u) at <= d
            labs_u = lab_dict[u]
            pruned = False
            if len(labs_u) < len(hub_labs):
                for h, dv in labs_u.items():
                    dh = hub_labs.get(h)
                    if dh is not None and dh + dv <= d + 1e-12:
                        pruned = True
                        break
            else:
                for h, dh in hub_labs.items():
                    dv = labs_u.get(h)
                    if dv is not None and dh + dv <= d + 1e-12:
                        pruned = True
                        break
            if pruned:
                continue
            tmp[u].append((hub, d, nh))
            labs_u[hub] = d
            for v, w in zip(g.adj_idx[u], g.adj_w[u]):
                if rank[v] <= rank[hub]:
                    continue   # only lower-importance vertices get labels
                nd = d + w
                if nd < dist[v] - 1e-12:
                    dist[v] = nd
                    touched.append(v)
                    # next hop from v toward hub is u
                    heapq.heappush(pq, (nd, v, u))
        for v in touched:
            dist[v] = np.inf
        touched.clear()

    labels = []
    for v in range(V):
        if tmp[v]:
            hs = np.array([h for h, _, _ in tmp[v]], dtype=np.int64)
            ds = np.array([d for _, d, _ in tmp[v]], dtype=np.float64)
            ns = np.array([n for _, _, n in tmp[v]], dtype=np.int64)
            srt = np.argsort(hs)
            labels.append((hs[srt], ds[srt], ns[srt]))
        else:
            labels.append((np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64)))
    return HubLabels(order=np.asarray(order), labels=labels)
