"""Query workloads — paper §Experiments.

``Unknown``: uniform random free-space pairs (stands in for the MovingAI
scenario files).  The clustered and workload-aware generators of the
reference (``repro.core.workload``) come with the adaptive-indexing slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geometry import Scene, random_free_points
from .visgraph import VisGraph, astar


@dataclasses.dataclass
class QuerySet:
    name: str
    s: np.ndarray     # [N,2]
    t: np.ndarray     # [N,2]


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
