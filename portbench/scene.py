"""The benchmark's own scenes: obstacle rectangles made from a config.

``rooms`` is a frozen copy of the port's ``core.maps.rooms_map`` placement
loop (the same draws from the same seed), so a configuration names a map by
generator, parameters and seed and both the port and the reference get the
same polygons from here.  ``free_points`` is the benchmark's own sampler of
query endpoints.
"""

from __future__ import annotations

import numpy as np


def _overlaps(r, placed, margin: float) -> bool:
    x0, y0, x1, y1 = r
    for (a0, b0, a1, b1) in placed:
        if x0 - margin < a1 and x1 + margin > a0 and \
                y0 - margin < b1 and y1 + margin > b0:
            return True
    return False


def rooms(seed: int = 0, width: float = 100.0, height: float = 100.0,
          n_rooms: int = 14, min_side: float = 5.0, max_side: float = 22.0
          ) -> np.ndarray:
    """[R, 4] float64 axis-aligned obstacles (x0, y0, x1, y1)."""
    rng = np.random.default_rng(seed)
    placed: list = []
    margin = 2.0
    tries = 0
    while len(placed) < n_rooms and tries < 4000:
        tries += 1
        w = rng.uniform(min_side, max_side)
        h = rng.uniform(min_side, max_side)
        x0 = rng.uniform(1.0, width - w - 1.0)
        y0 = rng.uniform(1.0, height - h - 1.0)
        r = (x0, y0, x0 + w, y0 + h)
        if not _overlaps(r, placed, margin):
            placed.append(r)
    return np.array(placed, dtype=np.float64).reshape(-1, 4)


GENERATORS = {"rooms": rooms}


class Map:
    """A configuration's map: its rectangles, extent and polygons."""

    def __init__(self, spec: dict):
        params = dict(spec["params"])
        self.rects = GENERATORS[spec["generator"]](seed=int(spec["seed"]),
                                                   **params)
        self.width = float(params["width"])
        self.height = float(params["height"])

    def polygons(self) -> list:
        """One [4, 2] corner list per rectangle, as ``rooms_map`` builds
        them (the port's ``Scene.build`` orders them counter-clockwise)."""
        return [np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
                for x0, y0, x1, y1 in self.rects]


#: points closer than this to an obstacle are drawn again: an endpoint the
#: float32 cast could move into an obstacle is no valid query
CLEARANCE = 1e-3


def near_obstacle(m: Map, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """[n] bool: point (x, y) lies within :data:`CLEARANCE` of an obstacle
    (or inside one)."""
    near = np.zeros(len(x), bool)
    for x0, y0, x1, y1 in m.rects:
        near |= ((x > x0 - CLEARANCE) & (x < x1 + CLEARANCE)
                 & (y > y0 - CLEARANCE) & (y < y1 + CLEARANCE))
    return near


def free_points(m: Map, n: int, rng: np.random.Generator) -> np.ndarray:
    """[n, 2] float32 points drawn uniformly over free space, each at least
    :data:`CLEARANCE` from every obstacle."""
    out = np.empty((n, 2), np.float32)
    got = 0
    while got < n:
        k = int(1.4 * (n - got)) + 64
        x = rng.uniform(0.0, m.width, k).astype(np.float32)
        y = rng.uniform(0.0, m.height, k).astype(np.float32)
        keep = np.flatnonzero(~near_obstacle(m, x, y))[:n - got]
        out[got:got + len(keep), 0] = x[keep]
        out[got:got + len(keep), 1] = y[keep]
        got += len(keep)
    return out
