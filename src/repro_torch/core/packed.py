"""Width-bucketed device slabs of an EHL/EHL* index and the batched query.

The host index (``core.grid``) stores ragged per-region label lists; the
online engine needs contiguous, gatherable tensors (DESIGN.md §4).  This
module packs them into a :class:`BucketedIndex`: regions grouped into
power-of-two width buckets (multiples of ``lane``), one dense float32 slab
per bucket, plus a ``region -> (bucket, row)`` indirection behind the cell
mapper.  Queries dispatch per bucket, so each pays only for the label width
its regions need.

Shared across buckets:

* ``edges_a/b/c``: flat obstacle-edge tensors for the query-time visibility
  predicate (``c`` is the CCW next vertex for the through-vertex rule;
  DESIGN.md §5).  Padding slots are degenerate (a == b == c), and at least
  one exists — the grid sentinel points at the last one.
* ``grid``: optional :class:`~repro_torch.core.edgegrid.EdgeGrid` that
  prunes the visibility predicate to the edges near each segment (DESIGN.md
  §10), attached by the packer when it pays (or forced with
  ``edge_grid=True``), bitwise-identical to the dense predicate.
* ``mapper``: cell -> region id, so point location is O(1).

The query runs in two halves per bucket batch, as the kernels need
materialised planes: :func:`_fold_endpoint` (locate, gather, visibility
fold through ``segvis``, or ``segvis_tiles`` over the edge grid) once per
endpoint side, then :func:`_join_endpoints` (co-visibility through the same
visibility dispatch, then the hub row join ``label_join_rowmin`` and the
min or argmin).  ``use_kernels`` picks the Hopper kernels (``kernels.ops``,
which run the twins on CPU tensors) or the plain twins (``kernels.ref``)
directly.

Everything on the device is float32/int32; the host oracle is float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .edgegrid import EdgeGrid, build_edge_grid, plan_grid, segvis_grid
from .grid import EHLIndex

HUB_PAD = np.int32(2 ** 30)     # sorts after every real hub id


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is present
    (callers that want the CPU say so with ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_edge_count(num_edges: int, lane: int = 128) -> int:
    """Packed edge-tensor length: lane-aligned with >= 1 degenerate slot."""
    return _round_up(num_edges + 1, lane)


def bucket_width(n_labels: int, lane: int = 128) -> int:
    """Smallest power-of-two multiple of ``lane`` holding ``n_labels``."""
    w = lane
    while w < n_labels:
        w *= 2
    return w


@dataclasses.dataclass
class BucketedIndex:
    """Width-bucketed layout: one dense float32 slab per label width.

    Region ``r`` lives at ``(region_bucket[r], region_row[r])``; slab ``k``
    has shape ``[R_k, widths[k]]``.  The mapper resolves cells to region ids
    (not rows), so point location composes with the indirection in O(1).
    """

    hub_ids: tuple          # per bucket: [R_k, W_k] int32 (HUB_PAD pads)
    via_xy: tuple           # per bucket: [R_k, W_k, 2] float32
    via_d: tuple            # per bucket: [R_k, W_k] float32 (+inf pads)
    via_ids: tuple          # per bucket: [R_k, W_k] int32 (-1 pads)
    mapper: torch.Tensor    # [C] int32 cell -> region id
    region_bucket: torch.Tensor     # [R] int32 region id -> bucket
    region_row: torch.Tensor        # [R] int32 region id -> row in its slab
    edges_a: torch.Tensor   # [E, 2] float32 (degenerate-padded)
    edges_b: torch.Tensor   # [E, 2] float32
    edges_c: torch.Tensor   # [E, 2] float32 CCW next vertex (§5 vertex rule)
    # static metadata
    nx: int
    ny: int
    cell_size: float
    width: float
    height: float
    widths: tuple           # per-bucket label width, strictly increasing
    grid: EdgeGrid | None = None    # edge-grid pruning (DESIGN.md §10)

    @property
    def device(self) -> torch.device:
        return self.mapper.device

    @property
    def num_buckets(self) -> int:
        return len(self.widths)

    @property
    def num_edges(self) -> int:
        return self.edges_a.shape[0]

    def device_bytes(self) -> int:
        slabs = sum(a.numel() * a.element_size()
                    for group in (self.hub_ids, self.via_xy, self.via_d,
                                  self.via_ids)
                    for a in group)
        fixed = sum(a.numel() * a.element_size() for a in
                    (self.mapper, self.region_bucket, self.region_row,
                     self.edges_a, self.edges_b, self.edges_c))
        return (int(slabs) + int(fixed)
                + (self.grid.device_bytes() if self.grid else 0))

    def bucket_stats(self) -> list[dict]:
        """Per-bucket occupancy: regions, used/total label slots, waste."""
        out = []
        for k, w in enumerate(self.widths):
            hub = self.hub_ids[k]
            used = int((hub != int(HUB_PAD)).sum())
            total = hub.numel()
            out.append(dict(bucket=k, width=w, regions=hub.shape[0],
                            used_slots=used, total_slots=total,
                            waste=1.0 - used / max(1, total)))
        return out


# ---------------------------------------------------------------------------
# packing (host -> device layout)
# ---------------------------------------------------------------------------

def _host_packs(index: EHLIndex):
    """Live regions in rid order with their packed (ragged) label arrays."""
    live = sorted(index.regions.keys())
    packs = [index.pack_region(index.regions[rid]) for rid in live]
    return live, packs


def _fill_row(arrs, i, p):
    hub_ids, via_xy, via_d, via_ids = arrs
    k = len(p["hubs"])
    hub_ids[i, :k] = p["hubs"]
    via_xy[i, :k] = p["via_xy"]
    via_d[i, :k] = p["d"]
    via_ids[i, :k] = p["vias"]


def _alloc_slab(rows: int, width: int):
    return (np.full((rows, width), HUB_PAD, dtype=np.int32),
            np.zeros((rows, width, 2), dtype=np.float32),
            np.full((rows, width), np.inf, dtype=np.float32),
            np.full((rows, width), -1, dtype=np.int32))


def _cell_mapper(index: EHLIndex, live: list) -> np.ndarray:
    """[C] int32 cell -> dense index into the live-region ordering."""
    row_of = {rid: i for i, rid in enumerate(live)}
    mapper = np.zeros(index.mapper.size, dtype=np.int32)
    for ci, rid in enumerate(index.mapper):
        mapper[ci] = row_of[int(rid)]
    return mapper


def _pack_edges(scene_or_index, lane: int):
    """Pack (a, b, c) edge arrays, degenerate-padded with >= 1 sentinel.

    Every padding slot is the degenerate triple (a == b == c), provably
    non-blocking under the §5 predicate for every query segment.
    """
    scene = getattr(scene_or_index, "scene", scene_or_index)
    edges = scene.edges
    enext = scene.edge_next
    E = edges.shape[0]
    Ep = padded_edge_count(E, lane)
    ea = np.zeros((Ep, 2), dtype=np.float32)
    eb = np.zeros((Ep, 2), dtype=np.float32)
    ec = np.zeros((Ep, 2), dtype=np.float32)
    if E:
        ea[:E] = edges[:, 0]
        eb[:E] = edges[:, 1]
        ec[:E] = enext
        ea[E:] = eb[E:] = ec[E:] = edges[0, 0]   # degenerate pads
    if not (np.array_equal(ea[E:], eb[E:]) and np.array_equal(eb[E:], ec[E:])
            and Ep > E):
        raise AssertionError("edge padding must be degenerate (a == b == c)")
    return ea, eb, ec


def _maybe_grid(ea: np.ndarray, eb: np.ndarray, num_real: int, scene,
                edge_grid: bool | None, dev: torch.device) -> EdgeGrid | None:
    """Build the edge grid when forced or when pruning pays.

    ``edge_grid=None`` (auto) attaches the grid only when the per-segment
    gathered tile (``3 * max(gnx, gny) * M`` slots) is smaller than the
    dense edge list; it decides host-side through :func:`plan_grid` before
    building anything.  ``True``/``False`` force.
    """
    if edge_grid is False:
        return None
    if edge_grid is None:
        gnx, gny, _, M = plan_grid(ea, eb, num_real, scene.width,
                                   scene.height)
        if 3 * max(gnx, gny) * M >= ea.shape[0]:
            return None
    return build_edge_grid(ea, eb, num_real, scene.width, scene.height,
                           sentinel=ea.shape[0] - 1, device=dev)


def plan_buckets(index: EHLIndex, lane: int = 128
                 ) -> tuple[list, list, np.ndarray]:
    """Bucket assignment from the grid's pack metadata — no device arrays.

    Returns (per-region label counts, bucket widths, region -> bucket).
    """
    counts = [max(1, int(c)) for c in index.packed_label_counts()]
    widths = sorted({bucket_width(c, lane) for c in counts}) or [lane]
    bucket_of_width = {w: k for k, w in enumerate(widths)}
    region_bucket = np.array([bucket_of_width[bucket_width(c, lane)]
                              for c in counts], dtype=np.int32)
    return counts, widths, region_bucket


def pack_bucketed(index: EHLIndex, lane: int = 128,
                  edge_grid: bool | None = None,
                  device="cuda") -> BucketedIndex:
    """Freeze a host index into width-bucketed slabs on ``device``.

    Each region goes into the smallest power-of-two-multiple-of-``lane``
    bucket that holds its label count, so padding waste is < 50% per region
    instead of being governed by the single largest merged region.

    ``edge_grid``: ``None`` attaches the §10 edge grid when pruning pays,
    ``True``/``False`` force it on/off.
    """
    dev = resolve_device(device)
    live, packs = _host_packs(index)
    _, widths, region_bucket = plan_buckets(index, lane)
    region_row = np.zeros(len(live), dtype=np.int32)
    members: list[list[int]] = [[] for _ in widths]
    for i, b in enumerate(region_bucket):
        region_row[i] = len(members[b])
        members[b].append(i)

    slabs = []
    for k, w in enumerate(widths):
        arrs = _alloc_slab(max(1, len(members[k])), w)
        for row, i in enumerate(members[k]):
            _fill_row(arrs, row, packs[i])
        slabs.append(arrs)

    ea, eb, ec = _pack_edges(index, lane)
    grid = _maybe_grid(ea, eb, index.scene.edges.shape[0], index.scene,
                       edge_grid, dev)
    return _to_device(dict(
        hub_ids=[a[0] for a in slabs], via_xy=[a[1] for a in slabs],
        via_d=[a[2] for a in slabs], via_ids=[a[3] for a in slabs],
        mapper=_cell_mapper(index, live), region_bucket=region_bucket,
        region_row=region_row, edges_a=ea, edges_b=eb, edges_c=ec,
        nx=index.nx, ny=index.ny, cell_size=index.cell_size,
        width=index.scene.width, height=index.scene.height,
        widths=widths, grid=grid), dev)


_PLANES = ("mapper", "region_bucket", "region_row",
           "edges_a", "edges_b", "edges_c")
_SLABS = ("hub_ids", "via_xy", "via_d", "via_ids")
_GRID_STATIC = ("gnx", "gny", "gcell", "sentinel", "eps")
_DTYPES = dict(hub_ids=np.int32, via_xy=np.float32, via_d=np.float32,
               via_ids=np.int32, mapper=np.int32, region_bucket=np.int32,
               region_row=np.int32, edges_a=np.float32, edges_b=np.float32,
               edges_c=np.float32)


def _to_device(planes: dict, dev: torch.device) -> BucketedIndex:
    def put(a):                 # np.array copies: no aliasing of the input
        return torch.as_tensor(np.array(a), device=dev)

    grid = planes.get("grid")
    if isinstance(grid, dict):
        grid = EdgeGrid(cell_ids=put(grid["cell_ids"]),
                        cell_len=put(grid["cell_len"]),
                        gnx=int(grid["gnx"]), gny=int(grid["gny"]),
                        gcell=float(grid["gcell"]),
                        sentinel=int(grid["sentinel"]),
                        eps=float(grid["eps"]))
    return BucketedIndex(
        **{k: tuple(put(a) for a in planes[k]) for k in _SLABS},
        **{k: put(planes[k]) for k in _PLANES},
        nx=int(planes["nx"]), ny=int(planes["ny"]),
        cell_size=float(planes["cell_size"]), width=float(planes["width"]),
        height=float(planes["height"]),
        widths=tuple(int(w) for w in planes["widths"]), grid=grid)


def bucketed_from_numpy(planes: dict, device) -> BucketedIndex:
    """A :class:`BucketedIndex` from another packer's planes, as numpy.

    ``planes`` holds the reference ``repro.core.packed.BucketedIndex``
    fields: every array as a numpy array, the per-bucket slabs as lists of
    them, the static metadata as plain values.  ``grid`` is None or a dict
    of the edge grid's ``cell_ids``/``cell_len`` numpy planes and its static
    fields (``gnx, gny, gcell, sentinel, eps``).  Lets two packages answer
    queries over the very same artifact.  Only the float32 layout is taken:
    quantized slabs raise.
    """
    grid = planes.get("grid")
    if grid is not None:
        missing = {"cell_ids", "cell_len", *_GRID_STATIC} - set(grid)
        if missing:
            raise ValueError(f"grid lacks {sorted(missing)}")
        ids, lens = np.asarray(grid["cell_ids"]), np.asarray(grid["cell_len"])
        if ids.dtype != np.int32 or lens.dtype != np.int32:
            raise ValueError("grid cell_ids and cell_len must be int32")
        rows = int(grid["gnx"]) * int(grid["gny"]) + 1
        if ids.ndim != 2 or ids.shape[0] != rows or lens.shape != (rows,):
            raise ValueError(f"grid planes must be [{rows}, M] and [{rows}]")
        num_edges = len(planes["edges_a"])
        if not (0 <= int(grid["sentinel"]) < num_edges
                and 0 <= ids.min() and ids.max() < num_edges):
            raise ValueError("grid edge ids outside the packed edges")
    for k in _SLABS:
        if len(planes[k]) != len(planes["widths"]):
            raise ValueError(f"{k}: one slab per bucket expected")
    for k, want in _DTYPES.items():
        arrs = planes[k] if k in _SLABS else [planes[k]]
        if any(np.asarray(a).dtype != want for a in arrs):
            raise ValueError(f"{k} must be {np.dtype(want)} (float32 layout)")
    return _to_device(planes, resolve_device(device))


# ---------------------------------------------------------------------------
# batched query engine (plain torch; kernels plug in via kernels.ops)
# ---------------------------------------------------------------------------

def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last (x, y) axis, one rounding per op."""
    x, y = v[..., 0], v[..., 1]
    return torch.sqrt(x * x + y * y)


def locate_regions(bx: BucketedIndex, pts: torch.Tensor) -> torch.Tensor:
    """[B] region ids for float32 query points (floor-divide + mapper)."""
    ix = torch.clamp((pts[:, 0] / bx.cell_size).to(torch.int32), 0, bx.nx - 1)
    iy = torch.clamp((pts[:, 1] / bx.cell_size).to(torch.int32), 0, bx.ny - 1)
    return bx.mapper[(iy * bx.nx + ix).long()]


def _segvis(p, q, bx: BucketedIndex, use_kernels: bool) -> torch.Tensor:
    """Visibility dispatch: grid-pruned when the artifact carries a grid.

    The grid path is bitwise-identical to the dense path (DESIGN.md §10
    superset argument), so this choice is invisible to every caller.
    """
    from repro_torch.kernels import ops

    if bx.grid is not None:
        return segvis_grid(p, q, bx.edges_a, bx.edges_b, bx.edges_c, bx.grid,
                           use_kernels=use_kernels)
    fn = ops.segvis_kernel if use_kernels else ops.segvis_ref
    return fn(p, q, bx.edges_a, bx.edges_b, bx.edges_c)


def _gather_bucketed(bx: BucketedIndex, regions: torch.Tensor, bucket: int):
    """Gather per-query labels from buckets <= ``bucket``, padded to its width.

    Regions living in a *wider* bucket than ``bucket`` come back as pure
    padding (HUB_PAD / inf) — the caller dispatches each query at the max
    of its endpoint buckets.
    """
    W = bx.widths[bucket]
    B = regions.shape[0]
    dev = regions.device
    hub = torch.full((B, W), int(HUB_PAD), dtype=torch.int32, device=dev)
    xy = torch.zeros((B, W, 2), dtype=torch.float32, device=dev)
    vd = torch.full((B, W), float("inf"), dtype=torch.float32, device=dev)
    vid = torch.full((B, W), -1, dtype=torch.int32, device=dev)

    regions = regions.long()
    src_bucket = bx.region_bucket[regions]
    src_row = bx.region_row[regions].long()
    for k in range(bucket + 1):
        w = bx.widths[k]
        rows = torch.clamp(src_row, 0, bx.hub_ids[k].shape[0] - 1)
        sel = src_bucket == k
        hub[:, :w] = torch.where(sel[:, None], bx.hub_ids[k][rows], hub[:, :w])
        xy[:, :w] = torch.where(sel[:, None, None], bx.via_xy[k][rows],
                                xy[:, :w])
        vd[:, :w] = torch.where(sel[:, None], bx.via_d[k][rows], vd[:, :w])
        vid[:, :w] = torch.where(sel[:, None], bx.via_ids[k][rows],
                                 vid[:, :w])
    return hub, xy, vd, vid


def _mask_labels(labels, pts: torch.Tensor, bx: BucketedIndex,
                 use_kernels: bool):
    """Per-endpoint half of Eq. 1-3: fold via visibility into distances.

    (hub [B,L], xy [B,L,2], d [B,L], vid [B,L]) -> (hub, vd, vid) where
    ``vd`` is inf wherever the via vertex is invisible from the query point.
    """
    hub, xy, d, vid = labels
    B, L = hub.shape
    vis = _segvis(torch.repeat_interleave(pts, L, dim=0), xy.reshape(-1, 2),
                  bx, use_kernels).reshape(B, L)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=pts.device)
    vd = torch.where(vis, _norm(pts[:, None] - xy) + d, inf)
    return hub, vd, vid


def _join_masked(masked_s, masked_t, s, t, covis, use_kernels: bool,
                 want_argmin: bool):
    """Join half of Eq. 1-3 over visibility-masked labels.

    The join emits the row-min form ``rowmin[b,i] = vd_s[b,i] + min_{hub
    match j} vd_t[b,j]`` and the argmin pair is recovered with two O(L)
    reductions (ties resolve to the first index).  ``covis`` overrides with
    the direct Euclidean distance.
    """
    from repro_torch.kernels import ops

    hub_s, vd_s, vid_s = masked_s
    hub_t, vd_t, vid_t = masked_t
    rowmin_join = (ops.label_join_rowmin_kernel if use_kernels
                   else ops.label_join_rowmin_ref)

    rowmin = rowmin_join(hub_s, vd_s, hub_t, vd_t)      # [B, L]
    d_label = rowmin.amin(dim=-1)
    d_direct = _norm(s - t)
    d = torch.where(covis, d_direct, d_label)
    if not want_argmin:
        return d

    inf = torch.tensor(float("inf"), dtype=torch.float32, device=s.device)
    i = torch.argmin(rowmin, dim=-1)                    # [B]
    hub_i = torch.gather(hub_s, 1, i[:, None])          # [B, 1]
    vd_t_match = torch.where(hub_t == hub_i, vd_t, inf)
    j = torch.argmin(vd_t_match, dim=-1)                # [B]
    via_s = torch.gather(vid_s, 1, i[:, None])[:, 0]
    via_t = torch.gather(vid_t, 1, j[:, None])[:, 0]
    return d, covis, via_s, hub_i[:, 0], via_t


def _fold_endpoint(bx: BucketedIndex, pts: torch.Tensor, bucket: int,
                   use_kernels: bool = False):
    """locate + gather + visibility-fold one endpoint side at ``bucket``."""
    pts = pts.to(torch.float32)
    r = locate_regions(bx, pts)
    labels = _gather_bucketed(bx, r, bucket)
    return _mask_labels(labels, pts, bx, use_kernels)


def _join_endpoints(bx: BucketedIndex, masked_s, masked_t, s: torch.Tensor,
                    t: torch.Tensor, use_kernels: bool = False,
                    want_argmin: bool = False):
    """Co-visibility + Eq. 1-3 join over folded endpoint sides."""
    s = s.to(torch.float32)
    t = t.to(torch.float32)
    covis = _segvis(s, t, bx, use_kernels)
    return _join_masked(masked_s, masked_t, s, t, covis, use_kernels,
                        want_argmin)


def query_batch_at_bucket(bx: BucketedIndex, s: torch.Tensor, t: torch.Tensor,
                          bucket: int, use_kernels: bool = False,
                          want_argmin: bool = False):
    """Eq. 1-3 over one dispatch bucket.

    Every query's endpoint regions must live in buckets <= ``bucket`` (i.e.
    ``bucket == max(endpoint buckets)`` after routing).  Returns d [B]
    float32, or with ``want_argmin`` (d, covis, via_s, hub, via_t).
    """
    s = torch.as_tensor(s, dtype=torch.float32, device=bx.device)
    t = torch.as_tensor(t, dtype=torch.float32, device=bx.device)
    ms = _fold_endpoint(bx, s, bucket, use_kernels=use_kernels)
    mt = _fold_endpoint(bx, t, bucket, use_kernels=use_kernels)
    return _join_endpoints(bx, ms, mt, s, t, use_kernels=use_kernels,
                           want_argmin=want_argmin)


def dispatch_buckets(bx: BucketedIndex, s, t) -> np.ndarray:
    """[B] dispatch bucket per query: max of the two endpoint buckets."""
    s = torch.as_tensor(np.asarray(s, np.float32), device=bx.device)
    t = torch.as_tensor(np.asarray(t, np.float32), device=bx.device)
    bs = bx.region_bucket[locate_regions(bx, s).long()]
    bt = bx.region_bucket[locate_regions(bx, t).long()]
    return torch.maximum(bs, bt).cpu().numpy()


def query_batch_bucketed(bx: BucketedIndex, s, t, use_kernels: bool = False,
                         want_argmin: bool = False):
    """Route a batch through per-bucket dispatch and scatter results back.

    Host-side convenience wrapper (PathServer does the same routing with
    fixed batch shapes and per-bucket stats): group queries by dispatch
    bucket, answer each group at its own width, reassemble in input order.
    """
    s = np.asarray(s, np.float32)
    t = np.asarray(t, np.float32)
    n = len(s)
    buckets = dispatch_buckets(bx, s, t) if n else np.zeros(0, np.int32)
    outs = empty_results(n, want_argmin)
    for k in np.unique(buckets):
        m = buckets == k
        res = query_batch_at_bucket(bx, s[m], t[m], bucket=int(k),
                                    use_kernels=use_kernels,
                                    want_argmin=want_argmin)
        for o, r in zip(outs, res if want_argmin else (res,)):
            o[m] = r.cpu().numpy()
    return tuple(outs) if want_argmin else outs[0]


def empty_results(n: int, want_argmin: bool) -> list:
    """Output buffers matching the engine dtypes: d [+ covis, label ids]."""
    if not want_argmin:
        return [np.empty(n, np.float32)]
    return [np.empty(n, np.float32), np.empty(n, bool),
            np.empty(n, np.int32), np.empty(n, np.int32),
            np.empty(n, np.int32)]
