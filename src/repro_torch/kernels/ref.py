"""Plain PyTorch twins of the Hopper kernels (bit-for-bit semantics).

Every CUDA kernel in this package has its twin here, written with one torch
op per arithmetic step so that every product, difference and sum is rounded
on its own — the same IEEE float32 arithmetic the kernels perform with
``__fmul_rn``/``__fsub_rn``/``__fadd_rn``.  The twins are the CPU path of
``kernels.ops`` and the oracle the kernels are held against on the card
(``torch.equal``).  Each twin counts its calls in ``<fn>.calls``, so a run
can show that a kernel path never fell back to it.
"""

from __future__ import annotations

import torch

# Zero-band width in units of float32 machine epsilon (DESIGN.md §5).  A
# cross product whose two partial products mathematically cancel (endpoint
# exactly on a vertex or edge line, degenerate a == b edge or p == q
# segment) can come back as a few-ulp residual instead of 0.0 when the
# difference is contracted into an fma; an 8x margin keeps every
# exact-contact class inside the band.  SIGN_BAND * eps = 2**-20 is a power
# of two, so ``tau`` is exact in every evaluation order.
SIGN_BAND = 8.0
BAND = SIGN_BAND * torch.finfo(torch.float32).eps


def cross3(ax, ay, bx, by, px, py):
    """2D cross product (b - a) x (p - a), broadcasting."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def filtered_signs(t1: torch.Tensor, t2: torch.Tensor):
    """(pos, neg) of ``t1 - t2`` with a fusion-proof relative zero band.

    ``|t1 - t2| <= SIGN_BAND * eps * (|t1| + |t2|)`` classifies as zero
    (neither pos nor neg), so the §5 degenerate rules see exact contact as
    contact however the arithmetic was compiled.
    """
    d = t1 - t2
    tau = BAND * (t1.abs() + t2.abs())
    return d > tau, d < -tau


def blocked_pairs(px, py, qx, qy, ax, ay, bx, by, cx, cy) -> torch.Tensor:
    """Per-(segment, edge) blocking predicate — the DESIGN.md §5 convention.

    All ten float32 operands broadcast together.  Touching never blocks;
    interior penetration always blocks: a proper crossing, a segment
    endpoint on the open edge with the other endpoint strictly inside, or
    the edge's b-vertex on the open segment with the arms ``a`` and ``c``
    strictly straddling it.  ``c == b`` disables the vertex rule and
    degenerate edges ``a == b`` never block (the padding guarantee).
    """
    pos1, neg1 = filtered_signs((bx - ax) * (py - ay), (by - ay) * (px - ax))
    pos2, neg2 = filtered_signs((bx - ax) * (qy - ay), (by - ay) * (qx - ax))
    pos3, neg3 = filtered_signs((qx - px) * (ay - py), (qy - py) * (ax - px))
    pos4, neg4 = filtered_signs((qx - px) * (by - py), (qy - py) * (bx - px))
    pos5, neg5 = filtered_signs((qx - px) * (cy - py), (qy - py) * (cx - px))
    straddle12 = (pos1 & neg2) | (neg1 & pos2)
    straddle34 = (pos3 & neg4) | (neg3 & pos4)
    proper = straddle12 & straddle34
    zero1 = ~pos1 & ~neg1
    zero2 = ~pos2 & ~neg2
    touch_pen = ((zero1 & pos2) | (zero2 & pos1)) & straddle34
    dx = qx - px
    dy = qy - py
    tb = (bx - px) * dx + (by - py) * dy
    l2 = dx * dx + dy * dy
    tau = BAND * l2
    on_seg = (~pos4 & ~neg4) & (tb > tau) & (tb < l2 - tau)
    vert_pen = on_seg & ((pos3 & neg5) | (neg3 & pos5))
    return proper | touch_pen | vert_pen


def segvis_ref(p: torch.Tensor, q: torch.Tensor, ea: torch.Tensor,
               eb: torch.Tensor, ec: torch.Tensor | None = None
               ) -> torch.Tensor:
    """[N] bool — True where segment p[i]->q[i] is blocked by NO edge.

    p, q: [N, 2] float32; ea, eb, ec: [E, 2] float32.  ``ec`` defaults to
    ``eb`` (vertex rule off) when adjacency is unknown.
    """
    segvis_ref.calls += 1
    if ec is None:
        ec = eb
    blocked = blocked_pairs(
        p[:, 0, None], p[:, 1, None], q[:, 0, None], q[:, 1, None],
        ea[None, :, 0], ea[None, :, 1], eb[None, :, 0], eb[None, :, 1],
        ec[None, :, 0], ec[None, :, 1])
    return ~blocked.any(dim=1)


segvis_ref.calls = 0


def segvis_tiles_ref(p: torch.Tensor, q: torch.Tensor,
                     ax: torch.Tensor, ay: torch.Tensor,
                     bx: torch.Tensor, by: torch.Tensor,
                     cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """[N] bool visibility over per-segment gathered edge tiles.

    The grid-pruned form: each segment i carries its own [S] edge slots
    (``core.edgegrid.gather_edge_tiles``, six [N, S] float32 planes);
    unused slots hold the degenerate sentinel (a == b == c), which
    :func:`blocked_pairs` never blocks on.  Same predicate body as
    :func:`segvis_ref`, so results are bitwise-identical whenever the tiles
    cover every blocking edge.
    """
    segvis_tiles_ref.calls += 1
    blocked = blocked_pairs(
        p[:, 0, None], p[:, 1, None], q[:, 0, None], q[:, 1, None],
        ax, ay, bx, by, cx, cy)
    return ~blocked.any(dim=1)


segvis_tiles_ref.calls = 0


def label_join_rowmin_ref(hub_s: torch.Tensor, vd_s: torch.Tensor,
                          hub_t: torch.Tensor, vd_t: torch.Tensor
                          ) -> torch.Tensor:
    """[B, L] — per s-label: vd_s[i] + min over t-labels with equal hub.

    The dense form of the paper's sorted merge-join (Eq. 3): the hub match
    is an L x L equality mask.  Distances are float32, bfloat16 or float16
    (+inf = invisible or padded slot); narrow ones are widened to float32
    first, so the sum is always taken and returned in float32.  A row with
    no match gives +inf.
    """
    label_join_rowmin_ref.calls += 1
    vd_s = vd_s.to(torch.float32)
    vd_t = vd_t.to(torch.float32)
    eq = hub_s[:, :, None] == hub_t[:, None, :]           # [B, L, L]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=vd_t.device)
    matchmin = torch.where(eq, vd_t[:, None, :], inf).amin(dim=-1)
    return vd_s + matchmin


label_join_rowmin_ref.calls = 0


def label_join_ref(hub_s, vd_s, hub_t, vd_t) -> torch.Tensor:
    """[B] — Eq. 3 distance through the best common hub."""
    return label_join_rowmin_ref(hub_s, vd_s, hub_t, vd_t).amin(dim=-1)
