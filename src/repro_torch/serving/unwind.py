"""Polyline unwinding from a per-index table of next-hop chains.

``core.query.unwind_path`` walks the hub labels' next-hop pointers for
every answer (a ``searchsorted`` per hop) and drops near-duplicate points
with a numpy ``edist`` per point.  Here every (vertex, hub) chain of the
labels is walked once per host index, on its first use, and kept as a
tuple of ``(x, y, row)`` points, so a polyline is two dict lookups and a
dedup in scalar float64.  The result equals ``core.query.unwind_path``'s
point for point.

The table of an index lives beside it, keyed by the index object's id and
dropped when the index is collected (a weak reference's callback); the
index and its pickle never see it.  A lookup checks that the weak
reference still names the index it is handed, so a reused id never reads
another index's chains.  A table is built whole and never written after,
so threads read it without a lock; two threads that build one for the
same index at once each get a correct table.
"""

from __future__ import annotations

import math
import weakref

import numpy as np

_TABLES: dict = {}          # id(index) -> (weakref to index, ChainTable)


class ChainTable:
    """The (vertex, hub) -> chain table of one host ``EHLIndex``, built from
    all of its labels: each chain the vertex sequence ``HubLabels.unwind(v,
    hub)`` returns, as ``(x, y, row)`` with the coordinates as Python floats
    and ``row`` the node's row of ``graph.nodes``.  A pair missing from the
    labels is missing here (``KeyError``); a next-hop cycle raises the
    labels' ``RuntimeError`` while the table is built."""

    def __init__(self, index):
        nodes = index.graph.nodes
        hl = index.hl
        pts = [(x, y, row) for (x, y), row in zip(nodes.tolist(), nodes)]
        self.chains = {(v, h): tuple(pts[u] for u in hl.unwind(v, h))
                       for v, (hubs, _, _) in enumerate(hl.labels)
                       for h in hubs.tolist()}


def chain_table(index) -> tuple[ChainTable, int]:
    """The chain table of ``index``, made on first use, and the number of
    chains this call walked from the labels (0 where the table was made
    before)."""
    key = id(index)
    hit = _TABLES.get(key)
    if hit is not None and hit[0]() is index:
        return hit[1], 0
    table = ChainTable(index)
    _TABLES[key] = (weakref.ref(index, lambda _, k=key: _TABLES.pop(k, None)),
                    table)
    return table, len(table.chains)


def unwind_path(index, s, t, via_s: int, hub: int, via_t: int) -> list:
    """The optimal polyline from a winning (via_s, hub, via_t): s, the
    chain from ``via_s`` up to ``hub`` and down to ``via_t``, t; a point
    is kept when it lies more than 1e-12 from the last one kept.  A list
    of float64 [2] arrays, equal to ``core.query.unwind_path``'s."""
    chains = chain_table(index)[0].chains
    up = chains[via_s, hub]
    down = chains[via_t, hub]
    s = np.asarray(s, np.float64)
    t = np.asarray(t, np.float64)
    lx, ly = s.tolist()
    path = [s]
    # sqrt(dx*dx + dy*dy) in float64 is edist's sqrt(((p - q)**2).sum())
    for x, y, row in up + down[-2::-1]:
        dx = lx - x
        dy = ly - y
        if math.sqrt(dx * dx + dy * dy) > 1e-12:
            path.append(row)
            lx, ly = x, y
    x, y = t.tolist()
    dx = lx - x
    dy = ly - y
    if math.sqrt(dx * dx + dy * dy) > 1e-12:
        path.append(t)
    return path
