"""EHL index: uniform grid overlay + per-cell via-labels.

Offline phase of the paper's EHL baseline:

* overlay a uniform grid (cell size = ``cell_size``; EHL-k uses ``k`` x the
  base size),
* for every convex vertex v compute its visibility polygon and mark every
  intersected cell (exact polygon/rect intersection, inflated by 1e-6 so
  sliver visibility errs toward inclusion — extra labels are always safe),
* copy the hub labels H(v) of every visible vertex into the cell as
  *via-labels* ``h : (v, d_vh)``.

A via-label is identified by the integer key ``h * V + v`` — the distance
``d_vh`` (and the next-hop used for path unwinding) is a function of (h, v)
and is re-attached when a region is *packed* for querying.  Regions (merged
cell groups, EHL* §Compression) keep two sorted int64 arrays: the label keys
and the distinct hub ids.

The device layouts built from this index (single slab vs width-bucketed
slabs, ``repro_torch.core.packed``) and their padding trade-offs are described in
DESIGN.md §4; :meth:`EHLIndex.packed_label_counts` is the pack metadata the
bucketing decision is made from.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .geometry import Scene, visibility_polygon, vispoly_intersects_rects
from .hublabel import HubLabels, build_hub_labels
from .visgraph import VisGraph, build_visgraph

LABEL_BYTES = 16   # (hub id, via id, dist, next-hop) — mirrors EHL's C++ entry
MAPPER_BYTES = 4


@dataclasses.dataclass
class Region:
    rid: int
    cells: list                 # cell ids
    keys: np.ndarray            # sorted int64 label keys (h*V + v)
    hubs: np.ndarray            # sorted int64 distinct hub ids
    score: float = 1.0
    version: int = 0            # bumped on every merge (lazy heap deletion)
    packed: dict | None = None  # query-time cache, invalidated on merge

    @property
    def n_labels(self) -> int:
        return int(self.keys.size)


@dataclasses.dataclass
class EHLIndex:
    scene: Scene
    graph: VisGraph
    hl: HubLabels
    cell_size: float
    nx: int
    ny: int
    mapper: np.ndarray           # [C] cell -> region id
    regions: dict                # rid -> Region (live regions only)

    # ------------------------------------------------------------------ grid
    def cell_of_point(self, p) -> int:
        ix = min(int(p[0] / self.cell_size), self.nx - 1)
        iy = min(int(p[1] / self.cell_size), self.ny - 1)
        return iy * self.nx + ix

    def cell_rect(self, ci: int) -> np.ndarray:
        iy, ix = divmod(ci, self.nx)
        cs = self.cell_size
        return np.array([ix * cs, iy * cs,
                         min((ix + 1) * cs, self.scene.width),
                         min((iy + 1) * cs, self.scene.height)])

    def cell_neighbors(self, ci: int):
        iy, ix = divmod(ci, self.nx)
        if ix > 0:
            yield ci - 1
        if ix < self.nx - 1:
            yield ci + 1
        if iy > 0:
            yield ci - self.nx
        if iy < self.ny - 1:
            yield ci + self.nx

    # ---------------------------------------------------------------- memory
    def label_memory(self) -> int:
        """Bytes of via-label storage (the quantity the budget constrains)."""
        return LABEL_BYTES * sum(r.n_labels for r in self.regions.values())

    def total_memory(self) -> int:
        return self.label_memory() + MAPPER_BYTES * self.mapper.size

    def region_of_point(self, p) -> Region:
        return self.regions[int(self.mapper[self.cell_of_point(p)])]

    def packed_label_counts(self) -> np.ndarray:
        """Per live region (rid order): packed label count — the row widths
        the device layouts pad from (single global Lmax vs per-bucket)."""
        live = sorted(self.regions.keys())
        return np.array([self.regions[rid].n_labels for rid in live],
                        dtype=np.int64)

    # ------------------------------------------------------------- snapshot
    def snapshot_regions(self) -> dict:
        """Cheap copy of the merge state (mapper + regions) for later restore.

        ``keys``/``hubs`` arrays and ``packed`` caches are shared by
        reference — merges *replace* them (``np.union1d`` allocates, the
        cache is dropped), never mutate in place — so a snapshot costs O(R)
        small objects, not a deep copy of the label data.  The adaptive
        planner snapshots the freshly built singleton index once and
        restores it when a workload shift demands re-splitting regions that
        earlier merges coarsened (merges are irreversible in Algorithm 1).
        """
        return dict(
            mapper=self.mapper.copy(),
            regions={rid: (list(r.cells), r.keys, r.hubs, r.score,
                           r.version, r.packed)
                     for rid, r in self.regions.items()})

    def restore_regions(self, snap: dict) -> None:
        """Reset mapper + regions to a :meth:`snapshot_regions` state."""
        self.mapper = snap["mapper"].copy()
        self.regions = {
            rid: Region(rid=rid, cells=list(cells), keys=keys, hubs=hubs,
                        score=score, version=version, packed=packed)
            for rid, (cells, keys, hubs, score, version, packed)
            in snap["regions"].items()}

    # ---------------------------------------------------------------- pack
    def pack_region(self, r: Region) -> dict:
        """Attach distances / coords to a region's label keys (cached)."""
        if r.packed is not None:
            return r.packed
        V = self.graph.num_nodes
        hubs = (r.keys // V).astype(np.int64)
        vias = (r.keys % V).astype(np.int64)
        d = np.empty(len(r.keys), dtype=np.float64)
        for i, (h, v) in enumerate(zip(hubs, vias)):
            hs, ds, _ = self.hl.labels[v]
            k = np.searchsorted(hs, h)
            d[i] = ds[k]
        order = np.lexsort((vias, hubs))
        uniq_vias, via_inv = np.unique(vias[order], return_inverse=True)
        r.packed = dict(hubs=hubs[order], vias=vias[order], d=d[order],
                        uniq_vias=uniq_vias, via_inv=via_inv,
                        via_xy=self.graph.nodes[vias[order]] if len(vias)
                        else np.zeros((0, 2)))
        return r.packed


def build_ehl(scene: Scene, cell_size: float,
              graph: VisGraph | None = None,
              hl: HubLabels | None = None,
              verbose: bool = False) -> EHLIndex:
    """Construct the (uncompressed) EHL index — one region per grid cell."""
    graph = graph if graph is not None else build_visgraph(scene)
    hl = hl if hl is not None else build_hub_labels(graph)
    V = graph.num_nodes
    nx = max(1, int(np.ceil(scene.width / cell_size)))
    ny = max(1, int(np.ceil(scene.height / cell_size)))
    C = nx * ny

    xs = np.arange(nx) * cell_size
    ys = np.arange(ny) * cell_size
    gx, gy = np.meshgrid(xs, ys)                       # [ny,nx]
    rects = np.stack([gx.ravel(), gy.ravel(),
                      np.minimum(gx.ravel() + cell_size, scene.width),
                      np.minimum(gy.ravel() + cell_size, scene.height)],
                     axis=1)                           # [C,4]

    # per-vertex label keys h*V+v (precomputed once)
    vkeys = [hl.labels[v][0] * V + v for v in range(V)]

    cell_key_parts: list[list[np.ndarray]] = [[] for _ in range(C)]
    for v in range(V):
        vp = visibility_polygon(scene, graph.nodes[v])
        # candidate cells from the polygon bbox
        bb = (vp[:, 0].min(), vp[:, 1].min(), vp[:, 0].max(), vp[:, 1].max())
        ix0 = max(0, int(bb[0] / cell_size) - 1)
        iy0 = max(0, int(bb[1] / cell_size) - 1)
        ix1 = min(nx - 1, int(bb[2] / cell_size) + 1)
        iy1 = min(ny - 1, int(bb[3] / cell_size) + 1)
        cand = (np.arange(iy0, iy1 + 1)[:, None] * nx
                + np.arange(ix0, ix1 + 1)[None, :]).ravel()
        hit = vispoly_intersects_rects(vp, graph.nodes[v], rects[cand])
        for ci in cand[hit]:
            cell_key_parts[ci].append(vkeys[v])
        if verbose and v % 50 == 0:
            print(f"  visibility {v}/{V}")

    mapper = np.arange(C, dtype=np.int64)
    regions = {}
    for ci in range(C):
        if cell_key_parts[ci]:
            keys = np.unique(np.concatenate(cell_key_parts[ci]))
            hubs = np.unique(keys // V)
        else:
            keys = np.zeros(0, dtype=np.int64)
            hubs = np.zeros(0, dtype=np.int64)
        regions[ci] = Region(rid=ci, cells=[ci], keys=keys, hubs=hubs)
    return EHLIndex(scene=scene, graph=graph, hl=hl, cell_size=cell_size,
                    nx=nx, ny=ny, mapper=mapper, regions=regions)
