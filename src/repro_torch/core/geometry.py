"""Geometry substrate for EHL*.

Euclidean plane with polygonal obstacles.  Everything here is exact-enough
float64 computational geometry executed host-side (offline phase); the online
phase consumes the flat edge tensors exported by :class:`Scene` (see
``repro_torch.core.packed`` / ``repro_torch.kernels``).

Conventions
-----------
* Obstacle polygons are simple, non-self-intersecting, stored CCW.
* Free space is the map rectangle minus open polygon interiors.  An agent may
  graze a polygon boundary (standard ESPP semantics).
* A *convex vertex* is a polygon corner whose interior angle is < 180 deg —
  the only points where optimal Euclidean paths bend.

Blocking convention (DESIGN.md §5): **touching != blocked, interior
penetration = blocked**.  A segment may slide along an obstacle edge, graze
a vertex tangentially, or end exactly on the boundary — none of that blocks
it.  It is blocked exactly when its open interior enters an obstacle's open
interior, *including* the degenerate entries: transversally through a
vertex, or from a point on an open edge heading strictly inside.  The host
oracle (:func:`visible_batch`, midpoint containment) realizes this
convention exactly in float64; :func:`segments_block_strict` is the same
convention written as the sign-rule predicate the device kernels implement
(``repro_torch.kernels``), so the two backends agree on every degenerate class
and differ only by float32 rounding.  The sign rules detect boundary
*crossings*, so their precondition is one endpoint in free space — every
engine segment satisfies it (query points are free, vias are boundary
vertices); a fully-interior segment is the oracle's job alone.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

EPS = 1e-9          # absolute tolerance in map units
ANG_EPS = 1e-7      # angular jitter for visibility-polygon rays


# ---------------------------------------------------------------------------
# scene
# ---------------------------------------------------------------------------

def _ensure_ccw(poly: np.ndarray) -> np.ndarray:
    """Return polygon with positive (CCW) signed area."""
    x, y = poly[:, 0], poly[:, 1]
    area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return poly if area2 > 0 else poly[::-1].copy()


@dataclasses.dataclass(frozen=True)
class Scene:
    """Immutable obstacle scene with precomputed flat edge/vertex tensors."""

    polygons: tuple          # tuple of [k,2] float64 arrays, CCW
    width: float
    height: float
    # derived, filled by `build`
    edges: np.ndarray        # [E,2,2] obstacle edges (a, b)
    edge_poly: np.ndarray    # [E] polygon id per edge
    vertices: np.ndarray     # [V,2] all polygon vertices
    vertex_poly: np.ndarray  # [V] polygon id per vertex
    convex_mask: np.ndarray  # [V] bool, True at convex corners
    edge_next: np.ndarray    # [E,2] vertex after b along the CCW boundary
    #   (through-vertex rule input; at a reflex b it is the sentinel
    #   2b - a, which makes the arm-straddle test fire for any segment
    #   through b that is not collinear with the incoming arm — correct,
    #   because every non-collinear direction enters a reflex interior)

    @staticmethod
    def build(polygons: Iterable[np.ndarray], width: float, height: float) -> "Scene":
        polys = tuple(_ensure_ccw(np.asarray(p, dtype=np.float64)) for p in polygons)
        edges, edge_poly, verts, vert_poly, convex, enext = [], [], [], [], [], []
        for pid, poly in enumerate(polys):
            n = len(poly)
            nxt = np.roll(poly, -1, axis=0)
            prv = np.roll(poly, 1, axis=0)
            edges.append(np.stack([poly, nxt], axis=1))
            edge_poly.append(np.full(n, pid))
            verts.append(poly)
            vert_poly.append(np.full(n, pid))
            e1 = poly - prv
            e2 = nxt - poly
            conv = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] > EPS
            convex.append(conv)
            # per edge i: a=poly[i], b=poly[i+1], c=poly[i+2] when b is
            # convex, else the reflex sentinel 2b - a
            conv_b = np.roll(conv, -1)
            nxt2 = np.roll(poly, -2, axis=0)
            enext.append(np.where(conv_b[:, None], nxt2, 2 * nxt - poly))
        if polys:
            E = np.concatenate(edges)
            EP = np.concatenate(edge_poly)
            V = np.concatenate(verts)
            VP = np.concatenate(vert_poly)
            C = np.concatenate(convex)
            EN = np.concatenate(enext)
        else:
            E = np.zeros((0, 2, 2))
            EP = np.zeros((0,), dtype=np.int64)
            V = np.zeros((0, 2))
            VP = np.zeros((0,), dtype=np.int64)
            C = np.zeros((0,), dtype=bool)
            EN = np.zeros((0, 2))
        return Scene(polys, float(width), float(height), E, EP, V, VP, C, EN)

    @property
    def convex_vertices(self) -> np.ndarray:
        """[CV,2] coordinates of convex corners (the visibility-graph nodes)."""
        return self.vertices[self.convex_mask]

    def boundary_edges(self) -> np.ndarray:
        """[4,2,2] map-rectangle edges (used to terminate visibility rays)."""
        w, h = self.width, self.height
        c = np.array([[0.0, 0.0], [w, 0.0], [w, h], [0.0, h]])
        return np.stack([c, np.roll(c, -1, axis=0)], axis=1)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]
    ) * (b[..., 0] - o[..., 0])


def points_strictly_inside(scene: Scene, pts: np.ndarray) -> np.ndarray:
    """[N] bool — point strictly inside ANY obstacle polygon (boundary = out).

    Even-odd crossing number computed per polygon, with an explicit
    on-boundary override.
    """
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    n = len(pts)
    if scene.edges.shape[0] == 0 or n == 0:
        return np.zeros(n, dtype=bool)
    a = scene.edges[:, 0]  # [E,2]
    b = scene.edges[:, 1]
    px = pts[:, 0, None]   # [N,1]
    py = pts[:, 1, None]
    ax, ay = a[None, :, 0], a[None, :, 1]
    bx, by = b[None, :, 0], b[None, :, 1]

    # crossing test (half-open rule avoids double counting at shared vertices)
    cond = (ay > py) != (by > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = ax + (py - ay) * (bx - ax) / (by - ay)
    crosses = cond & (px < xint)

    # on-boundary: distance point-to-segment < EPS
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby
    t = np.clip((apx * abx + apy * aby) / np.maximum(denom, 1e-30), 0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    on_bnd = (dx * dx + dy * dy) < EPS * EPS

    npoly = len(scene.polygons)
    pid = scene.edge_poly
    # [N, P] odd-crossing-count parity per polygon
    onehot = (pid[:, None] == np.arange(npoly)[None]).astype(np.int64)  # [E,P]
    cross_cnt = crosses.astype(np.int64) @ onehot                        # [N,P]
    inside_any = (cross_cnt % 2 == 1).any(axis=1)
    return inside_any & ~on_bnd.any(axis=1)


def _segment_edge_params(p, q, a, b):
    """Intersection parameters t along segment p->q for edges (a,b).

    Returns [*, 3] array of t values in [0,1] (NaN where no intersection):
    slot 0 = proper/touching crossing, slots 1,2 = collinear-overlap ends.
    Shapes: p,q [N,2]; a,b [E,2] -> out [N,E,3].
    """
    p = p[:, None, :]
    q = q[:, None, :]
    a = a[None, :, :]
    b = b[None, :, :]
    r = q - p                     # [N,1,2]
    s = b - a                     # [1,E,2]
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]      # [N,E]
    ap = a - p
    ap_x_s = ap[..., 0] * s[..., 1] - ap[..., 1] * s[..., 0]
    ap_x_r = ap[..., 0] * r[..., 1] - ap[..., 1] * r[..., 0]

    with np.errstate(divide="ignore", invalid="ignore"):
        t = ap_x_s / denom
        u = ap_x_r / denom
    parallel = np.abs(denom) < EPS
    hit = (~parallel) & (t >= -EPS) & (t <= 1 + EPS) & (u >= -EPS) & (u <= 1 + EPS)
    t0 = np.where(hit, np.clip(t, 0.0, 1.0), np.nan)

    # collinear overlap
    rr = (r * r).sum(-1)                                       # [N,1]
    collinear = parallel & (np.abs(ap_x_r) < EPS * np.sqrt(np.maximum(rr, 1e-30)))
    with np.errstate(divide="ignore", invalid="ignore"):
        ta = ((a - p) * r).sum(-1) / rr
        tb = ((b - p) * r).sum(-1) / rr
    lo = np.minimum(ta, tb)
    hi = np.maximum(ta, tb)
    ov = collinear & (hi >= -EPS) & (lo <= 1 + EPS)
    t1 = np.where(ov, np.clip(lo, 0.0, 1.0), np.nan)
    t2 = np.where(ov, np.clip(hi, 0.0, 1.0), np.nan)
    return np.stack([t0, t1, t2], axis=-1)                     # [N,E,3]


def visible(scene: Scene, p, q) -> bool:
    """Exact single-pair visibility (convenience wrapper)."""
    return visible_batch(scene, np.asarray(p)[None], np.asarray(q)[None])[0]


def visible_batch(scene: Scene, P: np.ndarray, Q: np.ndarray,
                  chunk: int = 512) -> np.ndarray:
    """[N] bool — open segment P[i]->Q[i] avoids all obstacle interiors.

    Method: collect every intersection parameter of the segment with any
    obstacle edge (crossings, touches, collinear overlaps), then test the
    midpoint of every consecutive parameter interval for strict containment
    in an obstacle.  Visible iff no midpoint is strictly inside.  This single
    rule subsumes proper crossings, tangencies, vertex grazing and
    fully-contained segments.
    """
    P = np.asarray(P, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    n = len(P)
    out = np.ones(n, dtype=bool)
    if scene.edges.shape[0] == 0 or n == 0:
        return out
    a = scene.edges[:, 0]
    b = scene.edges[:, 1]
    for lo in range(0, n, chunk):
        sl = slice(lo, min(lo + chunk, n))
        p, q = P[sl], Q[sl]
        ts = _segment_edge_params(p, q, a, b).reshape(len(p), -1)  # [n, 3E]
        ones = np.ones((len(p), 1))
        ts = np.concatenate([np.zeros_like(ones), ones, ts], axis=1)
        ts.sort(axis=1)  # NaNs go last
        mids_t = 0.5 * (ts[:, :-1] + ts[:, 1:])                    # [n, K]
        valid = np.isfinite(mids_t) & (ts[:, 1:] - ts[:, :-1] > EPS)
        ii, jj = np.nonzero(valid)
        if len(ii) == 0:
            continue
        mpts = p[ii] + mids_t[ii, jj, None] * (q[ii] - p[ii])
        inside = points_strictly_inside(scene, mpts)
        bad = np.zeros(len(p), dtype=bool)
        np.logical_or.at(bad, ii, inside)
        out[sl] = ~bad
    return out


def visible_from_point(scene: Scene, p: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """[M] bool — visibility of each target from a single point p."""
    P = np.broadcast_to(np.asarray(p, dtype=np.float64), (len(targets), 2))
    return visible_batch(scene, P, np.asarray(targets, dtype=np.float64))


# ---------------------------------------------------------------------------
# visibility polygon (angular sweep, star-shaped around the viewpoint)
# ---------------------------------------------------------------------------

def visibility_polygon(scene: Scene, v: np.ndarray) -> np.ndarray:
    """Star-shaped visibility polygon around viewpoint ``v``.

    Rays are cast at the angle of every scene vertex (obstacle + map corner)
    plus +-ANG_EPS jitter; each ray is clipped to the nearest obstacle / map
    boundary edge.  Returns [R,2] polygon vertices ordered by angle.
    """
    v = np.asarray(v, dtype=np.float64)
    edges = np.concatenate([scene.edges, scene.boundary_edges()], axis=0)
    pts = np.concatenate([scene.vertices,
                          scene.boundary_edges()[:, 0]], axis=0)
    rel = pts - v
    base = np.arctan2(rel[:, 1], rel[:, 0])
    angles = np.concatenate([base - ANG_EPS, base, base + ANG_EPS])
    angles = np.unique(angles)
    d = np.stack([np.cos(angles), np.sin(angles)], axis=1)      # [R,2]

    a = edges[:, 0][None]            # [1,E,2]
    b = edges[:, 1][None]
    s = b - a
    dr = d[:, None, :]               # [R,1,2]
    denom = dr[..., 0] * s[..., 1] - dr[..., 1] * s[..., 0]     # [R,E]
    av = a - v                        # [1,E,2]
    t = (av[..., 0] * s[..., 1] - av[..., 1] * s[..., 0])
    u = (av[..., 0] * dr[..., 1] - av[..., 1] * dr[..., 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = t / denom
        u = u / denom
    ok = (np.abs(denom) > 1e-15) & (t > EPS) & (u >= -EPS) & (u <= 1 + EPS)
    t = np.where(ok, t, np.inf)
    tmin = t.min(axis=1)                                        # [R]
    tmin = np.where(np.isfinite(tmin), tmin, 0.0)
    return v[None] + tmin[:, None] * d                          # [R,2]


def _point_in_star(vispoly: np.ndarray, v: np.ndarray, pts: np.ndarray,
                   slack: float = 1e-7) -> np.ndarray:
    """[N] bool — points inside the star-shaped polygon around v.

    Uses the radial lookup: a point at angle theta is inside iff it is on
    the v-side of the boundary *chord* between the two ray hits bracketing
    theta (the visible boundary between consecutive rays is the straight
    edge r0->r1).  ``slack`` is a world-units distance tolerance toward
    inclusion at the boundary.

    The side test must stay meaningful on *degenerate chords*: at a shadow
    discontinuity the ±ANG_EPS bracket rays hit the same point, the chord
    collapses, and both cross products shrink to ~0 — an absolute product
    slack then classified every point at that exact angle as inside, no
    matter how far out (scene vertices and map corners are all in the ray
    angle set, so e.g. a map corner sat at such an angle for *every*
    viewpoint, handing far-away cells phantom visibility).  Sign agreement
    is therefore exact, and the tolerance is the point's geometric distance
    to the chord (falling back to distance-to-hit when the chord length
    vanishes), which goes to zero only when the point really approaches
    the boundary.
    """
    rel = vispoly - v
    ang = np.arctan2(rel[:, 1], rel[:, 0])
    order = np.argsort(ang)
    ang = ang[order]
    rad = np.linalg.norm(rel[order], axis=1)
    # wrap
    ang = np.concatenate([ang, ang[:1] + 2 * np.pi])
    rad = np.concatenate([rad, rad[:1]])

    prel = pts - v
    pang = np.arctan2(prel[:, 1], prel[:, 0])
    prad = np.linalg.norm(prel, axis=1)
    pang = np.where(pang < ang[0], pang + 2 * np.pi, pang)   # wrap-around
    idx = np.searchsorted(ang, pang, side="right")
    idx = np.clip(idx, 1, len(ang) - 1)
    a0, a1 = ang[idx - 1], ang[idx]
    r0, r1 = rad[idx - 1], rad[idx]
    p0 = v + r0[:, None] * np.stack([np.cos(a0), np.sin(a0)], axis=1)
    p1 = v + r1[:, None] * np.stack([np.cos(a1), np.sin(a1)], axis=1)
    crossv = _cross(p0, p1, pts)
    crossc = _cross(p0, p1, np.broadcast_to(v, pts.shape))
    same_side = crossv * crossc > 0
    clen = np.linalg.norm(p1 - p0, axis=-1)
    dist = np.where(clen > 1e-12,
                    np.abs(crossv) / np.maximum(clen, 1e-12),
                    np.linalg.norm(pts - p0, axis=-1))
    return (same_side | (dist <= slack)) & (prad > 0)


def _segs_properly_cross(p0, p1, q0, q1):
    """Vectorized strict proper segment crossing ([N] bools).

    Sign-based (scale-invariant); touching/collinear contact is deliberately
    excluded — callers cover it with the containment conditions.
    """
    d1 = _cross(q0, q1, p0)
    d2 = _cross(q0, q1, p1)
    d3 = _cross(p0, p1, q0)
    d4 = _cross(p0, p1, q1)
    return (((d1 > 0) & (d2 < 0)) | ((d1 < 0) & (d2 > 0))) & \
           (((d3 > 0) & (d4 < 0)) | ((d3 < 0) & (d4 > 0)))


def _filtered_signs(t1, t2, band: float):
    """(pos, neg) of ``t1 - t2`` with a relative zero band.

    Float64 twin of ``repro_torch.kernels.ref.filtered_signs`` — values within
    ``band * eps * (|t1| + |t2|)`` of zero classify as neither, so exact
    contact stays contact under any evaluation order of the products.
    """
    eps = band * np.finfo(np.float64).eps
    d = t1 - t2
    tau = eps * (np.abs(t1) + np.abs(t2))
    return d > tau, d < -tau


def segments_block_strict(P, Q, A, B, C, band: float = 8.0) -> np.ndarray:
    """[N, E] bool — sign-rule blocking predicate (module convention).

    The float64 twin of the device predicate in ``repro_torch.kernels``: segment
    ``P[i]->Q[i]`` vs CCW obstacle edge ``(A[j], B[j])`` with ``C[j]`` the
    vertex after ``B[j]`` (:attr:`Scene.edge_next`).  Blocked iff

    * **proper crossing** — both sign straddles, outside the zero band; or
    * **endpoint-on-open-edge penetration** — a segment endpoint lies on the
      open edge (in-band) and the other endpoint is strictly on the interior
      (left) side of the edge line; or
    * **through-vertex transversal** — the edge's b-vertex lies strictly
      inside the segment (cross in-band, projection strictly interior) and
      the two boundary arms (a, c) strictly straddle the segment line.

    All contact that does not enter the interior (collinear slide, tangent
    graze, endpoint touch) is non-blocking.  Sign tests are banded
    (:func:`_filtered_signs`, same ``SIGN_BAND`` structure as the kernels)
    so degenerate contact classifies identically across compilers and
    precisions.  Degenerate edges (a == b) never block — two in-band values
    cannot carry opposite filtered signs, the padding/sentinel guarantee the
    device layouts rely on.

    Known boundary of the sign rules (shared by every device backend, so
    backends still agree): a segment that penetrates *collinearly through
    a reflex vertex* — sliding along an edge line and continuing into the
    interior where the boundary turns away — fires no rule (the arm it
    must straddle is collinear with it).  Reaching that configuration
    needs a reflex (non-convex) obstacle vertex plus a segment collinear
    with its edge whose continuation is interior; with the engine's
    segment population (both endpoints free or on the boundary) and
    convex-polygon scenes it cannot occur.  The midpoint oracle handles
    it; tests pin the limitation explicitly.
    """
    P = np.asarray(P, dtype=np.float64)[:, None, :]
    Q = np.asarray(Q, dtype=np.float64)[:, None, :]
    A = np.asarray(A, dtype=np.float64)[None, :, :]
    B = np.asarray(B, dtype=np.float64)[None, :, :]
    C = np.asarray(C, dtype=np.float64)[None, :, :]

    def signs(o, a, b):
        t1 = (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
        t2 = (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])
        return _filtered_signs(t1, t2, band)

    pos1, neg1 = signs(A, B, P)
    pos2, neg2 = signs(A, B, Q)
    pos3, neg3 = signs(P, Q, A)
    pos4, neg4 = signs(P, Q, B)
    pos5, neg5 = signs(P, Q, C)
    straddle12 = (pos1 & neg2) | (neg1 & pos2)
    straddle34 = (pos3 & neg4) | (neg3 & pos4)
    proper = straddle12 & straddle34
    # endpoint on the open edge, other endpoint strictly interior-side
    zero1 = ~pos1 & ~neg1
    zero2 = ~pos2 & ~neg2
    touch_pen = ((zero1 & pos2) | (zero2 & pos1)) & straddle34
    # edge's b-vertex strictly inside the segment, arms straddle
    d = Q - P
    tb = ((B - P) * d).sum(-1)
    L2 = (d * d).sum(-1)
    tau = band * np.finfo(np.float64).eps * L2
    on_seg = (~pos4 & ~neg4) & (tb > tau) & (tb < L2 - tau)
    vert_pen = on_seg & ((pos3 & neg5) | (neg3 & pos5))
    return proper | touch_pen | vert_pen


def blocked_strict_batch(scene: Scene, P, Q) -> np.ndarray:
    """[N] bool — any obstacle edge blocks, per :func:`segments_block_strict`.

    Float64 reference for the device backends; on degenerate (exact-contact)
    configurations it agrees with :func:`visible_batch` by construction.
    """
    if scene.edges.shape[0] == 0:
        return np.zeros(len(np.atleast_2d(P)), dtype=bool)
    return segments_block_strict(P, Q, scene.edges[:, 0], scene.edges[:, 1],
                                 scene.edge_next).any(axis=1)


def vispoly_intersects_rects(vispoly: np.ndarray, v: np.ndarray,
                             rects: np.ndarray, inflate: float = 1e-6
                             ) -> np.ndarray:
    """[C] bool — does the visibility polygon meet each axis rect?

    rects: [C,4] as (xmin, ymin, xmax, ymax).  Standard polygon/rect
    intersection: corner-in-polygon OR polygon-vertex-in-rect OR edge
    crossing.  Rects are inflated by ``inflate`` so sliver-visibility at
    region borders errs toward inclusion (extra labels are always safe).
    """
    rects = np.asarray(rects, dtype=np.float64)
    C = len(rects)
    xmin = rects[:, 0] - inflate
    ymin = rects[:, 1] - inflate
    xmax = rects[:, 2] + inflate
    ymax = rects[:, 3] + inflate

    # (1) any rect corner inside the star polygon
    corners = np.stack([
        np.stack([xmin, ymin], 1), np.stack([xmax, ymin], 1),
        np.stack([xmax, ymax], 1), np.stack([xmin, ymax], 1)], axis=1)  # [C,4,2]
    cin = _point_in_star(vispoly, v, corners.reshape(-1, 2)).reshape(C, 4).any(1)

    # (2) any vispoly vertex inside the rect (or the viewpoint itself)
    allpts = np.concatenate([vispoly, np.asarray(v, dtype=np.float64)[None]])
    px, py = allpts[:, 0], allpts[:, 1]
    pin = ((px[None] >= xmin[:, None]) & (px[None] <= xmax[:, None]) &
           (py[None] >= ymin[:, None]) & (py[None] <= ymax[:, None])).any(1)

    # (3) any vispoly edge crossing any rect edge
    e0 = vispoly
    e1 = np.roll(vispoly, -1, axis=0)                       # [R,2]
    rc = corners                                            # [C,4,2]
    rc1 = np.roll(corners, -1, axis=1)
    # broadcast [C,4,R]
    p0 = e0[None, None]
    p1 = e1[None, None]
    q0 = rc[:, :, None]
    q1 = rc1[:, :, None]
    xing = _segs_properly_cross(p0, p1, q0, q1).any(axis=(1, 2))
    return cin | pin | xing


def random_free_points(scene: Scene, n: int, rng: np.random.Generator
                       ) -> np.ndarray:
    """Sample n points uniformly from free space (rejection sampling)."""
    out = np.zeros((n, 2))
    got = 0
    while got < n:
        cand = rng.uniform([0, 0], [scene.width, scene.height],
                           size=(max(64, 2 * (n - got)), 2))
        keep = cand[~points_strictly_inside(scene, cand)]
        take = min(len(keep), n - got)
        out[got:got + take] = keep[:take]
        got += take
    return out


def edist(p, q) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return np.sqrt(((p - q) ** 2).sum(-1))
