"""Online query phase — scalar reference engine (paper Eqs. 1-3).

This is the host-side oracle the batched torch/CUDA engine is validated
against (see ``repro_torch.core.packed`` and ``repro_torch.kernels``).  It
follows the paper exactly:

1. if s and t are co-visible -> d = Edist(s, t);
2. otherwise locate regions via the mapper (O(1)), compute the minimal
   via-distance per hub (Eq. 2) with a query-time visibility check on each
   via vertex, and merge-join the two hub lists (Eq. 3);
3. the optimal path is unwound from the winning (via_s, hub, via_t) triple
   using the hub labels' next-hop pointers.
"""

from __future__ import annotations

import numpy as np

from .geometry import edist, visible_batch, visible_from_point
from .grid import EHLIndex


def _vdist_min(index: EHLIndex, p: np.ndarray, packed: dict
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-hub minimal via-distance for point p over a packed region.

    Returns (uniq_hubs [Hk], vdmin [Hk], argmin via vertex id [Hk]).
    """
    hubs = packed["hubs"]
    if hubs.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0), np.zeros(0, np.int64))
    vis = visible_from_point(index.scene, p, index.graph.nodes[packed["uniq_vias"]])
    lab_vis = vis[packed["via_inv"]]
    vd = np.where(lab_vis,
                  edist(p[None], packed["via_xy"]) + packed["d"], np.inf)
    uniq_hubs, start = np.unique(hubs, return_index=True)
    vdmin = np.minimum.reduceat(vd, start)
    # argmin via id within each hub group
    arg = np.empty(len(uniq_hubs), dtype=np.int64)
    bounds = np.append(start, len(hubs))
    for k in range(len(uniq_hubs)):
        seg = slice(bounds[k], bounds[k + 1])
        arg[k] = packed["vias"][seg][np.argmin(vd[seg])]
    return uniq_hubs, vdmin, arg


def query_distance(index: EHLIndex, s, t) -> float:
    """Shortest obstacle-avoiding distance (inf if unreachable)."""
    d, _ = query(index, s, t, want_path=False)
    return d


def query(index: EHLIndex, s, t, want_path: bool = True
          ) -> tuple[float, list]:
    s = np.asarray(s, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if visible_batch(index.scene, s[None], t[None])[0]:
        return float(edist(s, t)), [s, t]

    rs = index.region_of_point(s)
    rt = index.region_of_point(t)
    ps = index.pack_region(rs)
    pt = index.pack_region(rt)
    hs, vs, args_ = _vdist_min(index, s, ps)
    ht, vt, argt_ = _vdist_min(index, t, pt)

    # merge-join the two sorted unique-hub lists
    i = j = 0
    best = np.inf
    best_triple = None
    while i < len(hs) and j < len(ht):
        if hs[i] == ht[j]:
            tot = vs[i] + vt[j]
            if tot < best:
                best = tot
                best_triple = (int(args_[i]), int(hs[i]), int(argt_[j]))
            i += 1
            j += 1
        elif hs[i] < ht[j]:
            i += 1
        else:
            j += 1
    if not np.isfinite(best):
        return float("inf"), []
    if not want_path:
        return float(best), []
    return float(best), unwind_path(index, s, t, *best_triple)


def unwind_path(index: EHLIndex, s, t, via_s: int, hub: int, via_t: int
                ) -> list:
    """Reconstruct the optimal polyline from a winning (via_s, hub, via_t).

    Shared by the scalar oracle above and the batched argmin engines
    (``repro_torch.core.packed.query_batch_bucketed`` & the serving layer): the
    device side only identifies the winning label triple; the hub labels'
    next-hop pointers live host-side.
    """
    seq = index.hl.unwind(via_s, hub) + index.hl.unwind(via_t, hub)[::-1][1:]
    pts = [np.asarray(s, np.float64)] + \
        [index.graph.nodes[u] for u in seq] + [np.asarray(t, np.float64)]
    path = [pts[0]]
    for p in pts[1:]:
        if edist(path[-1], p) > 1e-12:
            path.append(p)
    return path


def path_length(path) -> float:
    if len(path) < 2:
        return 0.0 if path else float("inf")
    return float(sum(edist(path[k], path[k + 1]) for k in range(len(path) - 1)))
