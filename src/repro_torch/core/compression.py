"""EHL* compression phase — Algorithm 1 of the paper, faithful.

Greedy region merging under a byte budget:

* every cell starts as its own region with score ``s(c)`` (uniform 1, or
  workload-aware ``1 + w_c``),
* a min-heap keyed on score pops the cheapest region ``e``,
* ``adjacentRegionSelection`` picks the neighbouring region with the highest
  Jaccard similarity of *hub sets* (Eq. 4), or the blended criterion
  ``(1-alpha)*Jaccard + alpha/s(r')`` when a workload is supplied (Eq. 5,
  alpha = 0.2 per the paper),
* via-labels are merged by set union (identical copies collapse — the whole
  point), scores add, the mapper re-targets the absorbed cells,
* loop until ``label_memory() <= budget`` or one region remains (the paper's
  "budget unreachable" halt).

The loop is host-side numpy on purpose: it is the paper's *offline* phase and
inherently sequential (heap); the online phase is what runs on the GPU.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .grid import EHLIndex, Region


@dataclasses.dataclass
class CompressionStats:
    initial_bytes: int
    final_bytes: int
    budget: int
    merges: int
    regions: int
    hit_single_region: bool
    device_bytes: int | None = None   # set by compress_to_device_budget


def jaccard(a: np.ndarray, b: np.ndarray) -> float:
    """Jaccard similarity of two sorted int arrays (hub sets, Eq. 4)."""
    if a.size == 0 and b.size == 0:
        return 1.0   # merging two empty regions is free
    inter = np.intersect1d(a, b, assume_unique=True).size
    union = a.size + b.size - inter
    return inter / union


def adjacent_regions(index: EHLIndex, e: Region) -> list:
    """Live regions sharing a grid boundary with e (via the mapper)."""
    seen = {e.rid}
    out = []
    for ci in e.cells:
        for nb in index.cell_neighbors(ci):
            rid = int(index.mapper[nb])
            if rid not in seen:
                seen.add(rid)
                out.append(index.regions[rid])
    return out


def select_merge_target(e: Region, candidates: list,
                        alpha: float = 0.0) -> Region | None:
    """Eq. 4 (alpha=0) / Eq. 5 (alpha>0) adjacent-region selection."""
    best, best_val = None, -np.inf
    for r in candidates:
        sim = jaccard(e.hubs, r.hubs)
        val = sim if alpha == 0.0 else (1 - alpha) * sim + alpha / r.score
        if val > best_val:
            best, best_val = r, val
    return best


def merge_regions(index: EHLIndex, e: Region, r: Region) -> int:
    """Merge r into e (paper steps 1-3). Returns bytes saved."""
    from .grid import LABEL_BYTES

    before = e.n_labels + r.n_labels
    e.keys = np.union1d(e.keys, r.keys)
    e.hubs = np.union1d(e.hubs, r.hubs)
    e.cells.extend(r.cells)
    e.score += r.score
    e.version += 1
    e.packed = None
    index.mapper[np.asarray(r.cells, dtype=np.int64)] = e.rid
    del index.regions[r.rid]
    return LABEL_BYTES * (before - e.n_labels)


def rescore_regions(index: EHLIndex, cell_scores: np.ndarray) -> None:
    """``initializeScores`` over the *current* region set.

    Region score = sum of its member-cell scores, so re-scoring an already
    merged index with the cell scores it was merged under is a no-op — which
    is what lets :func:`compress_incremental` re-enter the loop with a fresh
    workload without resetting the merge state.
    """
    for r in index.regions.values():
        r.score = float(sum(cell_scores[c] for c in r.cells))


def compress(index: EHLIndex, budget_bytes: int,
             cell_scores: np.ndarray | None = None,
             alpha: float = 0.0,
             verbose: bool = False) -> CompressionStats:
    """Algorithm 1.  Mutates ``index`` in place; returns statistics.

    cell_scores: optional [C] array of initial per-cell scores
    (``initializeScores``); defaults to all-ones.  Workload-aware callers pass
    ``1 + w_c`` and ``alpha=0.2``.

    The loop itself never assumes singleton start regions, so this *is* the
    incremental form — :func:`compress_incremental` is the explicitly-named
    entry point the adaptive planner uses to resume a partially merged index
    under a new budget / workload.
    """
    initial = index.label_memory()
    if cell_scores is not None:
        rescore_regions(index, cell_scores)
    heap = [(r.score, r.rid, r.version) for r in index.regions.values()]
    heapq.heapify(heap)

    merges = 0
    mem = initial
    hit_single = False
    while mem > budget_bytes:
        if len(index.regions) <= 1:
            hit_single = True
            break
        score, rid, version = heapq.heappop(heap)
        e = index.regions.get(rid)
        if e is None or e.version != version:
            continue                         # stale heap entry
        cands = adjacent_regions(index, e)
        if not cands:                        # only possible when e is alone
            hit_single = True
            break
        r = select_merge_target(e, cands, alpha=alpha)
        mem -= merge_regions(index, e, r)
        heapq.heappush(heap, (e.score, e.rid, e.version))
        merges += 1
        if verbose and merges % 500 == 0:
            print(f"  merge {merges}: {mem / 1e6:.2f} MB, "
                  f"{len(index.regions)} regions")
    return CompressionStats(initial_bytes=initial, final_bytes=mem,
                            budget=budget_bytes, merges=merges,
                            regions=len(index.regions),
                            hit_single_region=hit_single)


def compress_to_fraction(index: EHLIndex, fraction: float, **kw
                         ) -> CompressionStats:
    """EHL*-x convenience: budget = x% of the index's current label memory."""
    return compress(index, int(index.label_memory() * fraction), **kw)


def compress_incremental(index: EHLIndex, budget_bytes: int,
                         cell_scores: np.ndarray | None = None,
                         alpha: float = 0.2,
                         verbose: bool = False) -> CompressionStats:
    """Resume Algorithm 1 from the index's **current** region set.

    The adaptive-serving entry point: instead of rebuilding from singleton
    cells (``build_ehl`` + :func:`compress`), re-score the live regions with
    a freshly recorded workload and keep merging until the — possibly
    smaller — budget holds again.  Already under budget -> zero merges, a
    cheap no-op.  Merging is correctness-preserving regardless of scores
    (label sets only ever grow per cell), so a resumed index answers every
    query identically to a fresh one at the same region partition.

    Merges cannot be undone here; when the planner decides newly hot cells
    need *finer* regions it restores the pre-merge snapshot
    (:meth:`EHLIndex.snapshot_regions`) and re-enters this same loop.
    """
    return compress(index, budget_bytes, cell_scores=cell_scores,
                    alpha=alpha, verbose=verbose)


def compress_to_device_budget(index: EHLIndex, device_budget_bytes: int,
                              cell_scores: np.ndarray | None = None,
                              alpha: float = 0.0, lane: int = 128,
                              max_rounds: int = 16,
                              verbose: bool = False,
                              layout=None) -> CompressionStats:
    """Merge until the packed *bucketed artifact* fits ``device_budget_bytes``.

    Algorithm 1's budget constrains host label memory; what serving pays is
    ``BucketedIndex.device_bytes()`` — labels plus bucket padding, mapper,
    indirection and edge tensors.  Outer loop: measure the analytic device
    footprint (``bucketed_device_bytes``, host arithmetic, no device
    tensors), derive a proportional label-byte target, resume the
    incremental merge, repeat until the artifact fits or one region
    remains.

    ``layout``: the :class:`~repro_torch.core.packed.SlabLayout` the
    artifact will be packed with (default f32).  A quantized layout packs
    ~3x more labels into the same budget, so the same device budget admits
    a finer region partition — the dtype is decided before merging.
    """
    from .packed import LAYOUT_F32, bucketed_device_bytes

    if layout is None:
        layout = LAYOUT_F32
    initial = index.label_memory()
    merges = 0
    hit_single = False
    if cell_scores is not None:
        rescore_regions(index, cell_scores)
    for _ in range(max_rounds):
        dev = bucketed_device_bytes(index, lane, layout=layout)
        if dev <= device_budget_bytes or len(index.regions) <= 1:
            break
        # labels shrink, fixed overhead (mapper/edges) doesn't: aim the label
        # budget proportionally below the overshoot, with a 5% safety margin
        ratio = min(0.95 * device_budget_bytes / dev, 0.95)
        target = int(index.label_memory() * ratio)
        st = compress(index, target, alpha=alpha, verbose=verbose)
        merges += st.merges
        if st.hit_single_region:
            hit_single = True
            break
    return CompressionStats(
        initial_bytes=initial, final_bytes=index.label_memory(),
        budget=device_budget_bytes, merges=merges,
        regions=len(index.regions), hit_single_region=hit_single,
        device_bytes=bucketed_device_bytes(index, lane, layout=layout))
