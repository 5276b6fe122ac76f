"""Plain PyTorch reference: shortest obstacle-avoiding Euclidean paths.

It works every answer out again from the benchmark's own rectangles and
query points, and takes nothing the port built: no index, graph, label or
table.  Among convex obstacles an optimal path bends only at obstacle
corners, so the visibility graph over the corners with all-pairs shortest
distances (Floyd-Warshall) gives ``d(s, t) = min(|st| if s sees t,
min over u, v of |su| + D[u, v] + |vt|)`` with s seeing u and t seeing v.

Visibility follows the port's convention (touching is not blocking): a
segment is blocked when its open interior meets a rectangle's open
interior.  For an axis-aligned rectangle that is an intersection of two open
parameter intervals, so the test is exact in float64.

``Arith`` sets the precision.  ``"f64"`` is the reference.  ``"bf16"`` and
``"fp8"`` are the controls: the same code with every input and every
intermediate result rounded to that type (computed in float32 between the
roundings), the precision one step below what a configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

#: the controls' rounding types
LOW_PRECISION = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


class Arith:
    """Working dtype and the rounding applied after every operation."""

    def __init__(self, precision: str = "f64"):
        self.precision = precision
        if precision == "f64":
            self.dtype, self.low = torch.float64, None
        else:
            self.dtype, self.low = torch.float32, LOW_PRECISION[precision]
            self.max = float(torch.finfo(self.low).max)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the working precision (saturating; infinities
        stay as they are)."""
        if self.low is None:
            return x
        fin = torch.isfinite(x)
        rounded = x.clamp(-self.max, self.max).to(self.low).to(self.dtype)
        return torch.where(fin, rounded, x)

    def tensor(self, a, device) -> torch.Tensor:
        return self.r(torch.as_tensor(np.asarray(a, np.float64),
                                      device=device).to(self.dtype))

    def dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = self.r(a - b)
        sq = self.r(self.r(d[..., 0] * d[..., 0])
                    + self.r(d[..., 1] * d[..., 1]))
        return self.r(torch.sqrt(sq))


def corners_of(rects: np.ndarray) -> np.ndarray:
    """[4R, 2] corners of [R, 4] rectangles (every corner is convex)."""
    x0, y0, x1, y1 = rects.T
    return np.stack([np.stack([x0, y0], 1), np.stack([x1, y0], 1),
                     np.stack([x1, y1], 1), np.stack([x0, y1], 1)],
                    axis=1).reshape(-1, 2)


def blocked(p: torch.Tensor, q: torch.Tensor, rects: torch.Tensor,
            ar: Arith, erode: float = 0.0) -> torch.Tensor:
    """[...] bool: segment p->q enters the open interior of a rectangle
    (each shrunk by ``erode`` on every side).  ``p``, ``q``: [..., 2],
    broadcastable; ``rects``: [R, 4]."""
    p = p[..., None, :]
    q = q[..., None, :]
    d = ar.r(q - p)
    inf = torch.tensor(float("inf"), dtype=ar.dtype, device=rects.device)
    lo = torch.zeros((), dtype=ar.dtype, device=rects.device)
    hi = torch.ones((), dtype=ar.dtype, device=rects.device)
    for ax in (0, 1):
        a0 = ar.r(rects[:, ax] + erode - p[..., ax])
        a1 = ar.r(rects[:, ax + 2] - erode - p[..., ax])
        dd = d[..., ax]
        flat = dd == 0
        safe = torch.where(flat, torch.ones_like(dd), dd)
        t0 = ar.r(a0 / safe)
        t1 = ar.r(a1 / safe)
        tl = torch.where(dd > 0, t0, t1)
        th = torch.where(dd > 0, t1, t0)
        # a segment parallel to this axis' slab lies inside it or not at all
        within = (a0 < 0) & (a1 > 0)
        tl = torch.where(flat, torch.where(within, -inf, inf), tl)
        th = torch.where(flat, torch.where(within, inf, -inf), th)
        lo = torch.maximum(lo, tl)
        hi = torch.minimum(hi, th)
    return (lo < hi).any(-1)


class Reference:
    """Shortest paths among one map's rectangles, in one precision."""

    def __init__(self, rects: np.ndarray, precision: str = "f64",
                 device="cpu"):
        self.ar = ar = Arith(precision)
        self.device = torch.device(device)
        self.rects64 = np.asarray(rects, np.float64)
        self.rects = ar.tensor(self.rects64, self.device)
        self.corners = ar.tensor(corners_of(self.rects64), self.device)
        c = self.corners
        V = len(c)
        vis = ~blocked(c[:, None], c[None], self.rects, ar)
        D = torch.where(vis, ar.dist(c[:, None], c[None]),
                        torch.tensor(float("inf"), dtype=ar.dtype,
                                     device=self.device))
        D.fill_diagonal_(0.0)
        idx = torch.arange(V, device=self.device)
        nxt = torch.where(torch.isfinite(D), idx[None].expand(V, V),
                          torch.full_like(D, -1, dtype=torch.long))
        for k in range(V):
            via = ar.r(D[:, k:k + 1] + D[k:k + 1, :])
            better = via < D
            D = torch.where(better, via, D)
            nxt = torch.where(better, nxt[:, k:k + 1].expand(V, V), nxt)
        self.D, self.nxt = D, nxt

    def label_qerr(self, dtype: torch.dtype) -> float:
        """Largest round-trip error of a corner-to-corner shortest distance
        stored as ``dtype``: the most any label distance of a slab of that
        type can be off (labels are such distances)."""
        D = self.D[torch.isfinite(self.D)].to(torch.float64)
        return float((D.to(dtype).to(torch.float64) - D).abs().max())

    def solve(self, s: np.ndarray, t: np.ndarray, block: int = 2048,
              want_paths: bool = False):
        """Distances [N] float64 (and, with ``want_paths``, polylines: lists
        of float64 points) for query endpoints ``s``, ``t`` [N, 2]."""
        ar = self.ar
        out = np.empty(len(s), np.float64)
        paths: list = []
        for lo in range(0, len(s), block):
            sb = ar.tensor(s[lo:lo + block], self.device)
            tb = ar.tensor(t[lo:lo + block], self.device)
            d, u, v, direct = self._block(sb, tb)
            out[lo:lo + len(sb)] = d.to(torch.float64).cpu().numpy()
            if want_paths:
                paths += self._polylines(s[lo:lo + block], t[lo:lo + block],
                                         u.cpu().numpy(), v.cpu().numpy(),
                                         direct.cpu().numpy())
        return (out, paths) if want_paths else out

    def _block(self, s, t):
        ar, c, inf = self.ar, self.corners, float("inf")
        V = len(c)
        a = torch.where(~blocked(s[:, None], c[None], self.rects, ar),
                        ar.dist(s[:, None], c[None]), inf)
        b = torch.where(~blocked(t[:, None], c[None], self.rects, ar),
                        ar.dist(t[:, None], c[None]), inf)
        direct = torch.where(~blocked(s, t, self.rects, ar), ar.dist(s, t),
                             inf)
        tot = ar.r(ar.r(a[:, :, None] + self.D[None]) + b[:, None, :])
        best, arg = tot.reshape(len(s), V * V).min(dim=1)
        use_direct = direct <= best
        d = torch.where(use_direct, direct, best)
        return d, arg // V, arg % V, use_direct

    def _polylines(self, s, t, u, v, direct) -> list:
        nxt = self.nxt.cpu().numpy()
        cs = corners_of(self.rects64)
        out = []
        for i in range(len(s)):
            p = [np.asarray(s[i], np.float64)]
            if not direct[i]:
                a = int(u[i])
                p.append(cs[a])
                while a != int(v[i]):
                    a = int(nxt[a, v[i]])
                    if a < 0:       # no path in this precision
                        break
                    p.append(cs[a])
            p.append(np.asarray(t[i], np.float64))
            out.append(p)
        return out
