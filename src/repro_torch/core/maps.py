"""Synthetic benchmark map generators.

The paper evaluates on MovingAI game benchmarks (DAO/DA/BG/SC), which are not
redistributable offline.  These generators produce polygonal scenes with the
same qualitative structure (rooms/corridors, convex clutter, maze walls) at
three sizes so every paper table has a stand-in suite.  All generators are
deterministic in the seed.
"""

from __future__ import annotations

import numpy as np

from .geometry import Scene


def _rect(x0, y0, x1, y1):
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], dtype=np.float64)


def _overlaps(r, placed, margin):
    x0, y0, x1, y1 = r
    for (a0, b0, a1, b1) in placed:
        if x0 - margin < a1 and x1 + margin > a0 and y0 - margin < b1 and y1 + margin > b0:
            return True
    return False


def rooms_map(seed: int = 0, width: float = 100.0, height: float = 100.0,
              n_rooms: int = 14, min_side: float = 5.0, max_side: float = 22.0
              ) -> Scene:
    """Axis-aligned rectangular obstacles ('rooms/buildings')."""
    rng = np.random.default_rng(seed)
    placed = []
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
    polys = [_rect(*r) for r in placed]
    return Scene.build(polys, width, height)


def scatter_map(seed: int = 0, width: float = 100.0, height: float = 100.0,
                n_obstacles: int = 16, radius: float = 7.0, kmax: int = 8
                ) -> Scene:
    """Random convex polygons (convex hulls of point clouds) — open terrain."""
    rng = np.random.default_rng(seed)
    from scipy.spatial import ConvexHull

    polys = []
    placed = []
    margin = 2.0
    tries = 0
    while len(polys) < n_obstacles and tries < 4000:
        tries += 1
        c = rng.uniform([radius + 1, radius + 1],
                        [width - radius - 1, height - radius - 1])
        r = rng.uniform(0.35 * radius, radius)
        bbox = (c[0] - r, c[1] - r, c[0] + r, c[1] + r)
        if _overlaps(bbox, placed, margin):
            continue
        k = rng.integers(4, kmax + 1)
        ang = np.sort(rng.uniform(0, 2 * np.pi, size=k))
        rad = rng.uniform(0.4 * r, r, size=k)
        pts = c + np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
        try:
            hull = ConvexHull(pts)
        except Exception:
            continue
        poly = pts[hull.vertices]
        if len(poly) >= 3:
            polys.append(poly)
            placed.append(bbox)
    return Scene.build(polys, width, height)


def maze_map(seed: int = 0, width: float = 100.0, height: float = 100.0,
             n_walls: int = 12, wall_len: float = 30.0, thickness: float = 2.0
             ) -> Scene:
    """Thin axis-aligned wall segments — corridor/maze structure."""
    rng = np.random.default_rng(seed)
    placed = []
    margin = 3.0
    tries = 0
    while len(placed) < n_walls and tries < 4000:
        tries += 1
        horizontal = rng.random() < 0.5
        L = rng.uniform(0.5 * wall_len, wall_len)
        if horizontal:
            x0 = rng.uniform(1.0, width - L - 1.0)
            y0 = rng.uniform(1.0, height - thickness - 1.0)
            r = (x0, y0, x0 + L, y0 + thickness)
        else:
            x0 = rng.uniform(1.0, width - thickness - 1.0)
            y0 = rng.uniform(1.0, height - L - 1.0)
            r = (x0, y0, x0 + thickness, y0 + L)
        if not _overlaps(r, placed, margin):
            placed.append(r)
    polys = [_rect(*q) for q in placed]
    return Scene.build(polys, width, height)


SUITES = {
    # name -> (generator, kwargs) — S/M/L roughly track DA / DAO-BG / SC scale
    "rooms-S": (rooms_map, dict(n_rooms=8, width=60.0, height=60.0)),
    "rooms-M": (rooms_map, dict(n_rooms=14)),
    "rooms-L": (rooms_map, dict(n_rooms=34, width=180.0, height=180.0)),
    "scatter-S": (scatter_map, dict(n_obstacles=8, width=60.0, height=60.0)),
    "scatter-M": (scatter_map, dict(n_obstacles=16)),
    "scatter-L": (scatter_map, dict(n_obstacles=40, width=180.0, height=180.0)),
    "maze-S": (maze_map, dict(n_walls=7, width=60.0, height=60.0)),
    "maze-M": (maze_map, dict(n_walls=12)),
    "maze-L": (maze_map, dict(n_walls=30, width=180.0, height=180.0)),
}


def make_map(name: str, seed: int = 0) -> Scene:
    gen, kw = SUITES[name]
    return gen(seed=seed, **kw)
