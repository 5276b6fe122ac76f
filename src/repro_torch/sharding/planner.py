"""Region -> shard placement: byte-balanced, locality-aware bin-packing.

EHL* budgets the index so it fits one device; past the point where merging
would destroy query performance, the remaining option is to *place* the
bucketed slabs across a device mesh.  The placement objective (DESIGN.md §9):

* **balance** — every shard's packed slab bytes within ``tol`` of the mean,
  so the per-device HBM budget is ``total / num_shards`` and no device is
  the memory straggler;
* **locality** — spatially adjacent cells co-locate, so clustered traffic
  (the workloads EHL*'s workload-aware mode optimizes for) resolves both
  endpoints on one shard and skips the cross-shard label gather.

The two are served in order: regions are walked in Morton (Z-curve) order
of their cell centroids and cut into ``num_shards`` contiguous runs sized
by slab bytes; a bounded refinement pass then moves boundary-adjacent
regions off the heaviest shard (toward the shard whose centroid is
nearest) until the balance tolerance holds.  Slab bytes per region are
exact — ``bucket_width(labels) * bytes_per_slot`` — because a region's
bucket width is invariant under sharding (see ``pack_bucketed_split``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.grid import EHLIndex
from repro_torch.core.packed import (LAYOUT_F32, SlabLayout, _grid_bytes,
                                     bucket_width, dtype_bytes,
                                     pack_bucketed_split, padded_edge_count)


def _morton(ix: np.ndarray, iy: np.ndarray, bits: int = 16) -> np.ndarray:
    """Interleave-bit Z-curve codes for integer grid coordinates."""
    code = np.zeros(ix.shape, dtype=np.int64)
    ix = ix.astype(np.int64)
    iy = iy.astype(np.int64)
    for b in range(bits):
        code |= ((ix >> b) & 1) << (2 * b)
        code |= ((iy >> b) & 1) << (2 * b + 1)
    return code


def region_centroids(index: EHLIndex) -> np.ndarray:
    """[R, 2] mean cell-center (grid coords) per live region, rid order."""
    live = sorted(index.regions.keys())
    row_of = {rid: i for i, rid in enumerate(live)}
    acc = np.zeros((len(live), 3), dtype=np.float64)     # sx, sy, n
    for ci, rid in enumerate(index.mapper):
        i = row_of[int(rid)]
        iy, ix = divmod(ci, index.nx)
        acc[i, 0] += ix + 0.5
        acc[i, 1] += iy + 0.5
        acc[i, 2] += 1.0
    return acc[:, :2] / np.maximum(acc[:, 2:3], 1.0)


@dataclasses.dataclass
class ShardPlan:
    """A placement: region -> shard, with its predicted byte profile."""
    num_shards: int
    assignment: np.ndarray      # [R] int32, live-rid order
    slab_bytes: np.ndarray      # [S] predicted packed slab bytes per shard
    moves: int                  # refinement moves the balance pass needed
    tol: float

    @property
    def imbalance(self) -> float:
        """max/mean of per-shard slab bytes (1.0 = perfectly balanced)."""
        return float(self.slab_bytes.max() / max(1.0, self.slab_bytes.mean()))


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard slabs + the host-side (cell)->(shard,bucket,row) routing
    table.  Each shard's ``BucketedIndex`` already lives on its own device
    (``pack_bucketed_split`` packs it there); the routing arrays stay
    host-side numpy."""

    shards: tuple               # per-shard BucketedIndex
    plan: ShardPlan
    region_shard: np.ndarray    # [R] region -> shard
    region_local: np.ndarray    # [R] region -> local id within its shard
    cell_shard: np.ndarray      # [C] cell -> owning shard
    cell_local: np.ndarray      # [C] cell -> local region id in that shard
    cell_bucket: np.ndarray     # [C] cell -> local bucket index
    cell_row: np.ndarray        # [C] cell -> row within that bucket's slab
    cell_width: np.ndarray      # [C] cell -> bucket width (join-width input)
    edge_masks: list            # per shard: [E] bool clipped-edge subset
    shard_rects: np.ndarray     # [S, 4] owned-cell bounding boxes (covis)
    nx: int
    ny: int
    cell_size: float
    width_classes: tuple        # sorted union of all shards' bucket widths

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_regions(self) -> int:
        return self.region_shard.shape[0]

    @property
    def devices(self) -> list:
        """The device of each shard."""
        return [bx.device for bx in self.shards]

    def per_shard_bytes(self) -> list:
        return [bx.device_bytes() for bx in self.shards]

    def device_bytes(self) -> int:
        """Total bytes across the mesh (mapper/edges replicated per shard)."""
        return int(sum(self.per_shard_bytes()))

    def max_shard_bytes(self) -> int:
        return int(max(self.per_shard_bytes()))

    def imbalance(self) -> float:
        b = np.array(self.per_shard_bytes(), dtype=np.float64)
        return float(b.max() / max(1.0, b.mean()))

    def bucket_stats(self) -> list:
        """Per-(shard, bucket) occupancy rows (ShardStats feeds on these)."""
        out = []
        for k, bx in enumerate(self.shards):
            for row in bx.bucket_stats():
                out.append(dict(shard=k, **row))
        return out

    def edge_bytes(self) -> list:
        """Per-shard clipped edge-tensor (+ grid) bytes — the replication
        the clip eliminated is ``num_shards * full_edge_bytes - sum(this)``.
        """
        out = []
        for bx in self.shards:
            b = int(sum(a.numel() * a.element_size()
                        for a in (bx.edges_a, bx.edges_b, bx.edges_c)))
            out.append(b + (bx.grid.device_bytes() if bx.grid else 0))
        return out


def sharded_overhead_bytes(index: EHLIndex, num_shards: int,
                           lane: int = 128,
                           layout: SlabLayout = LAYOUT_F32) -> int:
    """Upper bound on extra device bytes sharding adds vs single-device.

    Each shard replicates the full-grid mapper; edge tensors are *clipped*
    per shard (owned-region clip boxes, ``pack_bucketed_split``), so the
    worst case — every clip keeping every edge, plus the edge grid that
    clip would carry (`_grid_bytes` mirrors the packers' attach policy) —
    is the bound used here.  The budget-driven compression targets
    ``budget - overhead``, and a conservative overhead only ever lands the
    artifact further under budget; ``ShardedIndex.edge_bytes`` reports the
    realized clip savings.
    """
    if num_shards <= 1:
        return 0
    Ep = padded_edge_count(index.scene.edges.shape[0], lane)
    # edge_grid=True: a clipped subset may attach a grid even when the full
    # edge set's auto policy stays dense, so bound with the forced grid.
    # Quantized layouts also replicate the shared [V, 2] vertex table
    # (dtype_bytes.per_vertex) on every shard.
    per_shard_fixed = (index.mapper.size * 4 + 3 * Ep * 2 * 4
                       + index.graph.num_nodes * dtype_bytes(layout).per_vertex
                       + _grid_bytes(index, lane, True))
    return (num_shards - 1) * per_shard_fixed


class ShardPlanner:
    """Plan and build region-sharded artifacts over ``num_shards`` devices."""

    def __init__(self, num_shards: int, lane: int = 128, tol: float = 1.15,
                 max_moves: int | None = None,
                 layout: SlabLayout = LAYOUT_F32):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = int(num_shards)
        self.lane = int(lane)
        self.tol = float(tol)
        self.max_moves = max_moves
        self.layout = layout

    # ------------------------------------------------------------------ plan
    def plan(self, index: EHLIndex) -> ShardPlan:
        S = self.num_shards
        counts = index.packed_label_counts()
        R = len(counts)
        if R < S:
            raise ValueError(f"{R} regions cannot fill {S} shards — "
                             "compress less or use fewer shards")
        lb = dtype_bytes(self.layout)
        rb = np.array([bucket_width(max(1, int(c)), self.lane) * lb.per_slot
                       + lb.per_row for c in counts], dtype=np.int64)
        cent = region_centroids(index)
        order = np.argsort(
            _morton(cent[:, 0].astype(np.int64), cent[:, 1].astype(np.int64)),
            kind="stable")

        # contiguous Morton runs, each closed at the running fair share
        assignment = np.zeros(R, dtype=np.int32)
        total = int(rb.sum())
        shard, acc, spent = 0, 0, 0
        for pos, r in enumerate(order):
            remaining_regions = R - pos
            remaining_shards = S - shard
            target = (total - spent) / remaining_shards
            if shard < S - 1 and acc > 0 and (
                    acc + rb[r] / 2 >= target
                    or remaining_regions <= remaining_shards):
                shard += 1
                acc = 0
            assignment[r] = shard
            acc += int(rb[r])
            spent += int(rb[r])

        slab = np.bincount(assignment, weights=rb, minlength=S)
        # bounded rebalance: peel the heaviest shard's best-fitting region
        # toward the lightest until the tolerance holds
        moves = 0
        limit = self.max_moves if self.max_moves is not None else 4 * R
        tol_target = self.tol * slab.mean()
        while slab.max() > tol_target and moves < limit:
            hi = int(slab.argmax())
            lo = int(slab.argmin())
            members = np.nonzero(assignment == hi)[0]
            if members.size <= 1:
                break
            gap = slab[hi] - slab[lo]
            # candidates that actually shrink the gap, nearest to the
            # receiving shard's centroid first (locality-preserving)
            fits = members[rb[members] < gap]
            if fits.size == 0:
                break
            lo_cent = cent[assignment == lo].mean(axis=0)
            r = fits[np.argmin(((cent[fits] - lo_cent) ** 2).sum(axis=1))]
            assignment[r] = lo
            slab[hi] -= rb[r]
            slab[lo] += rb[r]
            moves += 1
        return ShardPlan(num_shards=S, assignment=assignment,
                         slab_bytes=slab.astype(np.int64), moves=moves,
                         tol=self.tol)

    # ----------------------------------------------------------------- build
    def build(self, index: EHLIndex, plan: ShardPlan | None = None,
              reuse_edges_from=None, edge_grid: bool | None = None,
              device="cuda") -> ShardedIndex:
        """Pack the planned placement into per-shard device artifacts.

        ``device``: one device whose type the shards round-robin over, or
        one device per shard (``pack_bucketed_split``); ``cuda`` raises
        without a card.  ``reuse_edges_from``: previous-generation
        artifact(s) whose clipped edge tensors are aliased where the clip is
        unchanged (the hot-swap repack fast path) — a per-shard sequence or
        a previous ``ShardedIndex`` (whose stored edge masks gate the
        reuse).
        """
        if plan is None:
            plan = self.plan(index)
        reuse_masks = None
        if isinstance(reuse_edges_from, ShardedIndex):
            reuse_masks = list(reuse_edges_from.edge_masks)
            reuse_edges_from = list(reuse_edges_from.shards)
        shards, route = pack_bucketed_split(
            index, plan.assignment, plan.num_shards, lane=self.lane,
            reuse_edges_from=reuse_edges_from, reuse_edge_masks=reuse_masks,
            edge_grid=edge_grid, layout=self.layout, device=device)
        classes = sorted({w for bx in shards for w in bx.widths})
        return ShardedIndex(
            shards=tuple(shards), plan=plan,
            region_shard=route["region_shard"],
            region_local=route["region_local"],
            cell_shard=route["cell_shard"],
            cell_local=route["cell_local"],
            cell_bucket=route["cell_bucket"],
            cell_row=route["cell_row"],
            cell_width=route["cell_width"],
            edge_masks=route["edge_mask"],
            shard_rects=route["shard_rects"],
            nx=index.nx, ny=index.ny, cell_size=float(index.cell_size),
            width_classes=tuple(classes))
