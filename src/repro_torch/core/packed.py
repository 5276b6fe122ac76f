"""Device slabs of an EHL/EHL* index and the batched query.

The host index (``core.grid``) stores ragged per-region label lists; the
online engine needs contiguous, gatherable tensors (DESIGN.md §4).  This
module packs them two ways:

* :class:`PackedIndex` — one slab whose rows are padded to the global
  maximum label count (``pack_index``); the mapper yields slab rows.
* :class:`BucketedIndex` — regions grouped into power-of-two width buckets
  (multiples of ``lane``), one dense slab per bucket, plus a ``region ->
  (bucket, row)`` indirection behind the cell mapper.  Queries dispatch
  per bucket, so each pays only for the label width its regions need.

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

The query runs in two halves per batch (per bucket batch on the bucketed
layout), as the kernels need materialised planes: :func:`_fold_endpoint`
(locate, gather, visibility fold through ``segvis``, or ``segvis_tiles``
over the edge grid) once per endpoint side, then :func:`_join_endpoints`
(co-visibility through the same visibility dispatch, then the hub row join
``label_join_rowmin`` and the min or argmin).  ``use_kernels`` picks the
Hopper kernels (``kernels.ops``, which run the twins on CPU tensors) or the
plain twins (``kernels.ref``) directly.  The query path makes its scalar
operands with ``torch.full`` (a fill kernel), never ``torch.tensor`` (a
copy from pageable host memory, which synchronises a CUDA stream), so a
batch is dispatched without waiting on the device.  :data:`TRACES` counts
the first sighting of each entry's shape key, the warmup check.

The sharded serving primitives (``repro_torch.sharding``, DESIGN.md §9)
live here too: :func:`pack_bucketed_split` packs per-shard slabs with
clipped edge sets straight onto each shard's device, and the cross-shard
entries (:func:`gather_masked_labels`, :func:`covis_blocked`,
:func:`join_masked`, the quantized wire :func:`gather_quant_rows` /
:func:`dequant_masked_labels`) are the fold and join above, cut so that
each side folds on its owning shard.

Everything the query computes is float32/int32; the host oracle is
float64.

**Quantized slabs (DESIGN.md §11).**  A :class:`SlabLayout` other than
``LAYOUT_F32`` stores the label slabs narrow: distances as bf16/f16 (per
bucket back to f32 when a finite distance would overflow), hub and via ids
delta-encoded per row into 2-byte slots against int32 row bases (per bucket
back to raw int32 when a row's id range exceeds 0xFFFE), and the per-slot
``via_xy`` plane replaced by one shared ``[V, 2]`` vertex table.  20 bytes
a slot become 6.  The 2-byte ids are stored as ``torch.int16`` holding the
u16 bit pattern (pad 0xFFFF reads as -1), on every device alike, since
int16 gathers and compares run everywhere; the gather decodes them to
exact int32 (:func:`_decode_ids`) and widens the distances, so the fold,
the join and the kernels see float32/int32 as on the f32 layout.
Distances come back within ``2*qerr`` of the f32 engine; argmin winners
equal the f32 engine's bit for bit through the residual rescue: the argmin
join flags rows whose margin is within the quantization error
(:func:`_join_masked` ``qerr2``), and those rows are answered again with
the exact f32 distance rows of the host-side :class:`ResidualTable`
(:func:`rescue_exact`, :func:`splice_rescue`).  The encoders are host
numpy (bf16 through torch's own conversion on the CPU), so the slabs equal
the reference's byte for byte.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs.locks import make_lock

from .edgegrid import (EdgeGrid, build_edge_grid, ell_bytes, plan_grid,
                       segvis_grid)
from .grid import EHLIndex

HUB_PAD = np.int32(2 ** 30)     # sorts after every real hub id
U16_PAD = 0xFFFF                # delta-encoded pad sentinel (u16 id slabs)
# device storage of the u16 delta ids: the same 2 bytes as int16, where the
# pad 0xFFFF reads as -1
U16_STORAGE = torch.int16
_DIST_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """On-device slab dtypes.

    ``dist``: f32 | bf16 | f16 — label-distance storage dtype.
    ``ids``:  i32 | u16       — hub/via id storage (u16 = per-row delta).

    The f32/i32 default is the float32 layout; any quantized layout also
    drops the per-slot ``via_xy`` pair in favour of the shared vertex
    table.
    """

    dist: str = "f32"
    ids: str = "i32"

    def __post_init__(self):
        if self.dist not in _DIST_DTYPES:
            raise ValueError(f"unknown distance dtype {self.dist!r}")
        if self.ids not in ("i32", "u16"):
            raise ValueError(f"unknown id dtype {self.ids!r}")

    @property
    def quantized(self) -> bool:
        return self.dist != "f32" or self.ids != "i32"

    @property
    def dist_dtype(self) -> torch.dtype:
        return _DIST_DTYPES[self.dist]


LAYOUT_F32 = SlabLayout()


def slab_layout(name: str) -> SlabLayout:
    """CLI spelling -> layout: 'f32'/'off' | 'bf16' | 'f16'."""
    if name in ("f32", "off", "none", ""):
        return LAYOUT_F32
    if name in ("bf16", "f16"):
        return SlabLayout(dist=name, ids="u16")
    raise ValueError(f"unknown slab layout {name!r} (f32 | bf16 | f16)")


@dataclasses.dataclass(frozen=True)
class LayoutBytes:
    """Analytic byte costs of a :class:`SlabLayout` (see :func:`dtype_bytes`)."""
    per_slot: int               # bytes per label slot (slab area term)
    per_row: int                # bytes per slab row (delta-encoding bases)
    per_vertex: int             # bytes per graph vertex (shared xy table)


def dtype_bytes(layout: SlabLayout = LAYOUT_F32) -> LayoutBytes:
    """Per-slot/per-row/per-vertex bytes of a layout: the one source of the
    byte math of :func:`bucketed_device_bytes`.  Assumes no per-bucket
    fallback (the realized ``device_bytes()`` is authoritative when a
    bucket overflowed its narrow dtype)."""
    if not layout.quantized:
        return LayoutBytes(per_slot=4 + 8 + 4 + 4,  # hub + xy + d + vid
                           per_row=0, per_vertex=0)
    id_b = 2 if layout.ids == "u16" else 4
    dist_b = layout.dist_dtype.itemsize
    return LayoutBytes(per_slot=2 * id_b + dist_b,  # hub_enc + d + via_enc
                       per_row=(8 if layout.ids == "u16" else 0),
                       per_vertex=8)                # shared [V, 2] f32 table


class ResidualTable:
    """Host-side exact f32 distance rows — the residual the rescue reads.

    Per bucket, the pre-quantization float32 ``via_d`` slab plus int32
    routing mirrors (mapper / region -> bucket / row), ~4 bytes per label
    slot of host memory.  Only *distances* are kept: the device slabs
    already decode hub/via ids to their exact int32 values, so the rescue
    only has to replace the quantized distance term
    (:func:`gather_masked_exact`).  Host-resident, never uploaded whole —
    ambiguous batches gather [B, W] rows and ship just those.
    """

    def __init__(self, d_slabs, region_bucket, region_row, mapper,
                 widths, nx: int, ny: int, cell_size: float):
        self.d = [np.ascontiguousarray(np.asarray(a, np.float32))
                  for a in d_slabs]
        self.region_bucket = np.asarray(region_bucket, np.int32)
        self.region_row = np.asarray(region_row, np.int32)
        self.mapper = np.asarray(mapper, np.int32)
        self.widths = tuple(int(w) for w in widths)
        self.nx, self.ny = int(nx), int(ny)
        self.cell_size = float(cell_size)

    def locate(self, pts: np.ndarray) -> np.ndarray:
        """[B] region ids — the same float32 floor-divide as
        :func:`locate_regions`, so host rows match device gathers exactly."""
        p = np.asarray(pts, np.float32)
        cs = np.float32(self.cell_size)
        ix = np.clip((p[:, 0] / cs).astype(np.int32), 0, self.nx - 1)
        iy = np.clip((p[:, 1] / cs).astype(np.int32), 0, self.ny - 1)
        return self.mapper[iy * self.nx + ix]

    def gather_d(self, regions: np.ndarray, width: int) -> np.ndarray:
        """[B, width] exact f32 distance rows, inf-padded — the host mirror
        of the distance plane of :func:`_gather_bucketed`."""
        regions = np.asarray(regions)
        out = np.full((len(regions), width), np.inf, np.float32)
        b = self.region_bucket[regions]
        r = self.region_row[regions]
        for k, w in enumerate(self.widths):
            if w > width:
                continue        # wider buckets stay padding, as on device
            m = b == k
            if m.any():
                rows = np.minimum(r[m], self.d[k].shape[0] - 1)
                out[np.nonzero(m)[0][:, None],
                    np.arange(w)[None, :]] = self.d[k][rows]
        return out


class TraceCounter:
    """Counts the first sighting of each serving entry's shape key.

    The port's analogue of the reference's jit trace counter.  Every fold
    and join entry reports its key (entry, device, layout, bucket width or
    slab, batch rows, argmin, distance dtype) with :meth:`see`; a key not
    seen before bumps ``count`` and ``entry_cold_total{entry=}`` in the
    process-wide registry.  On the card a
    cold key means new allocator segments for that shape (and, once the
    fixed-shape entries are captured as CUDA graphs, a capture), so serving
    code checks that warmup left nothing cold: snapshot ``count``, serve,
    require it unchanged.  Keys hold no artifact identity: the kernels and
    the allocator see shapes, not artifacts.

    The registry series put cold keys in the exports next to the serving
    series they perturb (DESIGN.md §12/§13).  Two
    profiling hooks ride along (DESIGN.md §13): a *thread-local* count
    (:meth:`thread_count`) lets :class:`repro_torch.obs.CompileCapture`
    tell that a call met a cold key without crediting a background build
    thread's keys to a foreground serving call, and ``profiler`` is the
    installed capture (None when profiling is off — the only cost then is
    one attribute read per entry call, :func:`_serving_entry`).
    """

    def __init__(self):
        self.count = 0
        self.profiler = None            # CompileCapture | None
        self._seen: set = set()
        self._tl = threading.local()
        self._lock = make_lock("obs.series")

    def thread_count(self) -> int:
        """Cold keys met by the calling thread."""
        return getattr(self._tl, "count", 0)

    def see(self, entry: str, *key) -> None:
        key = (entry,) + key
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.count += 1
        self._tl.count = self.thread_count() + 1
        obs.REGISTRY.counter("entry_cold_total", entry=entry).inc()


TRACES = TraceCounter()

#: The serving entries, every ``@_serving_entry("name")`` in this module, in
#: rough serving-path order (the reference's ``TRACE_ENTRIES``).
SERVING_ENTRIES = (
    "fold_endpoint",
    "join_endpoints",
    "gather_labels_at_width",
    "join_gathered",
    "gather_masked_labels",
    "covis_blocked",
    "join_masked",
    "gather_masked_exact",
    "gather_quant_rows",
    "dequant_masked_labels",
)


def _serving_entry(entry: str):
    """Name a serving entry and route it through the installed profiler.

    With no profiler the wrapper costs one attribute read and one ``is
    None`` per call.  With one installed (:func:`repro_torch.obs.
    enable_profile`) the call goes through ``CompileCapture.call``, which
    times it and attributes it when the entry's ``TRACES.see`` met a cold
    key on this thread.  The body must report its key with
    ``TRACES.see(entry, ...)`` under the same name.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            prof = TRACES.profiler
            if prof is None:
                return fn(*args, **kw)
            return prof.call(entry, fn, args, kw)

        wrapper.entry = entry
        return wrapper
    return deco


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
class PackedIndex:
    """Single-slab layout: one [R, L] slab, every row padded to the global
    maximum label count rounded up to ``lane``.

    The mapper resolves cells to slab rows directly.  Hub rows are sorted
    with ``HUB_PAD`` only at the tail (the join kernel's fast path).
    """

    hub_ids: torch.Tensor   # [R, L] int32 (HUB_PAD pads) or u16 delta bits
    #                         as int16 (§11)
    via_xy: torch.Tensor | None     # [R, L, 2] float32, or None (§11)
    via_d: torch.Tensor     # [R, L] f32/bf16/f16 (+inf pads)
    via_ids: torch.Tensor   # [R, L] int32 (-1 pads) or u16
    mapper: torch.Tensor    # [C] int32 cell -> slab row
    edges_a: torch.Tensor   # [E, 2] float32 (degenerate-padded)
    edges_b: torch.Tensor   # [E, 2] float32
    edges_c: torch.Tensor   # [E, 2] float32 CCW next vertex (§5 vertex rule)
    # static metadata
    nx: int
    ny: int
    cell_size: float
    width: float
    height: float
    grid: EdgeGrid | None = None    # edge-grid pruning (DESIGN.md §10)
    # quantized-layout extras (§11) — all None under the f32 layout
    vert_xy: torch.Tensor | None = None     # [V, 2] f32 shared vertex table
    hub_base: torch.Tensor | None = None    # [R] i32 per-row hub id base
    vid_base: torch.Tensor | None = None    # [R] i32 per-row via id base
    qerr: torch.Tensor | None = None        # f32 scalar max |f32(dq) - d|
    layout: SlabLayout = LAYOUT_F32
    residual: ResidualTable | None = dataclasses.field(
        default=None, repr=False, compare=False)   # host-side, not uploaded

    @property
    def device(self) -> torch.device:
        return self.mapper.device

    @property
    def num_regions(self) -> int:
        return self.hub_ids.shape[0]

    @property
    def label_width(self) -> int:
        return self.hub_ids.shape[1]

    @property
    def num_edges(self) -> int:
        return self.edges_a.shape[0]

    def device_bytes(self) -> int:
        arrs = (self.hub_ids, self.via_xy, self.via_d, self.via_ids,
                self.mapper, self.edges_a, self.edges_b, self.edges_c,
                self.vert_xy, self.hub_base, self.vid_base)
        base = sum(a.numel() * a.element_size()
                   for a in arrs if a is not None)
        return int(base) + (self.grid.device_bytes() if self.grid else 0)

    def label_slots(self) -> tuple[int, int]:
        """(used, total) label slots — padding waste is total - used."""
        return int(_used_mask(self.hub_ids).sum()), self.hub_ids.numel()

    def quant_stats(self) -> dict:
        """Realized quantization record (fallbacks are loud, not silent)."""
        return _quant_stats(self.layout, (self.hub_ids,), (self.via_d,),
                            (self.via_ids,), self.qerr)


@dataclasses.dataclass
class BucketedIndex:
    """Width-bucketed layout: one dense slab per label width.

    Region ``r`` lives at ``(region_bucket[r], region_row[r])``; slab ``k``
    has shape ``[R_k, widths[k]]``.  The mapper resolves cells to region ids
    (not rows), so point location composes with the indirection in O(1).
    """

    hub_ids: tuple          # per bucket: [R_k, W_k] int32 (HUB_PAD pads)
    #                         or u16 delta bits as int16 (§11)
    via_xy: tuple           # per bucket: [R_k, W_k, 2] float32 (or () §11)
    via_d: tuple            # per bucket: [R_k, W_k] f32/bf16/f16 (+inf pads)
    via_ids: tuple          # per bucket: [R_k, W_k] int32 (-1 pads) or u16
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
    # quantized-layout extras (§11) — all None/() under the f32 layout
    vert_xy: torch.Tensor | None = None     # [V, 2] f32 shared vertex table
    hub_base: tuple = ()                    # per bucket: [R_k] i32 row base
    vid_base: tuple = ()                    # per bucket: [R_k] i32 row base
    qerr: torch.Tensor | None = None        # f32 scalar max |f32(dq) - d|
    layout: SlabLayout = LAYOUT_F32
    residual: ResidualTable | None = dataclasses.field(
        default=None, repr=False, compare=False)   # host-side, not uploaded

    @property
    def device(self) -> torch.device:
        return self.mapper.device

    @property
    def num_buckets(self) -> int:
        return len(self.widths)

    @property
    def num_regions(self) -> int:
        return self.region_bucket.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges_a.shape[0]

    def device_bytes(self) -> int:
        slabs = sum(a.numel() * a.element_size()
                    for group in (self.hub_ids, self.via_xy, self.via_d,
                                  self.via_ids, self.hub_base, self.vid_base)
                    for a in group)
        fixed = sum(a.numel() * a.element_size() for a in
                    (self.mapper, self.region_bucket, self.region_row,
                     self.edges_a, self.edges_b, self.edges_c))
        if self.vert_xy is not None:
            fixed += self.vert_xy.numel() * self.vert_xy.element_size()
        return (int(slabs) + int(fixed)
                + (self.grid.device_bytes() if self.grid else 0))

    def bucket_stats(self) -> list[dict]:
        """Per-bucket occupancy: regions, used/total label slots, waste."""
        out = []
        for k, w in enumerate(self.widths):
            hub = self.hub_ids[k]
            used = int(_used_mask(hub).sum())
            total = hub.numel()
            out.append(dict(bucket=k, width=w, regions=hub.shape[0],
                            used_slots=used, total_slots=total,
                            waste=1.0 - used / max(1, total)))
        return out

    def label_slots(self) -> tuple[int, int]:
        """(used, total) label slots across all buckets."""
        st = self.bucket_stats()
        return (sum(s["used_slots"] for s in st),
                sum(s["total_slots"] for s in st))

    def quant_stats(self) -> dict:
        """Realized quantization record (fallbacks are loud, not silent)."""
        return _quant_stats(self.layout, self.hub_ids, self.via_d,
                            self.via_ids, self.qerr)


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


# ---------------------------------------------------------------------------
# quantized slab encoding (DESIGN.md §11), host numpy
# ---------------------------------------------------------------------------

def _used_mask(hub: torch.Tensor) -> torch.Tensor:
    """Real-label mask for either id encoding (u16 sentinel vs HUB_PAD)."""
    if hub.dtype == U16_STORAGE:
        return hub != -1                        # 0xFFFF as int16
    return hub != int(HUB_PAD)


def encode_delta_u16(ids: np.ndarray, valid: np.ndarray):
    """Per-row delta encoding of an id slab into u16 + [R] i32 bases.

    Returns ``(enc, base)`` with pad slots at the ``0xFFFF`` sentinel, or
    ``(None, None)`` when any row's id range exceeds 65534 — the caller
    must then keep the raw i32 slab (the loud per-bucket fallback).
    """
    ids = np.asarray(ids, np.int64)
    any_valid = valid.any(axis=1)
    lo = np.where(valid, ids, np.iinfo(np.int64).max).min(axis=1)
    lo = np.where(any_valid, lo, 0)
    hi = np.where(valid, ids, np.iinfo(np.int64).min).max(axis=1)
    hi = np.where(any_valid, hi, 0)
    if int((hi - lo).max(initial=0)) > U16_PAD - 1:
        return None, None
    enc = np.where(valid, ids - lo[:, None], U16_PAD)
    return enc.astype(np.uint16), lo.astype(np.int32)


def _narrow(d: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float32 array rounded to ``dtype`` (round to nearest even), as a
    CPU tensor: f16 through numpy's cast, bf16 through torch's."""
    if dtype == torch.float16:
        return torch.from_numpy(d.astype(np.float16))
    return torch.from_numpy(d).to(dtype)


def encode_dist(d: np.ndarray, dtype: torch.dtype) -> tuple:
    """Quantize a f32 distance slab; returns ``(dq, qerr)``, ``dq`` a CPU
    tensor of ``dtype``.

    ``(None, 0.0)`` when any *finite* distance overflows to inf in the
    narrow dtype (f16 tops out at 65504) — per-bucket fallback to f32.
    +inf pads are representable in every dtype and round-trip exactly.
    """
    d = np.ascontiguousarray(np.asarray(d, np.float32))
    with np.errstate(over="ignore"):
        dq = _narrow(d, dtype)
    back = dq.to(torch.float32).numpy()
    finite = np.isfinite(d)
    if np.any(finite & ~np.isfinite(back)):
        return None, 0.0
    err = np.abs(back[finite] - d[finite])
    return dq, float(err.max(initial=0.0))


def _u16_tensor(enc: np.ndarray) -> torch.Tensor:
    """u16 delta ids as their device storage: the same bits as int16."""
    return torch.from_numpy(np.array(enc, np.uint16).view(np.int16))


def _quantize_slab(arrs, layout: SlabLayout):
    """Encode one (hub, xy, d, vid) f32 slab into the quantized layout.

    Returns CPU tensors ``(hub, d, vid, hub_base, vid_base)`` and ``qerr``:
    ids u16-delta as int16 bits (or raw int32 on range overflow, per
    bucket), distances in ``layout.dist_dtype`` (or float32 on
    finite-overflow, per bucket).  The ``via_xy`` plane is dropped: it is
    always ``vert_xy[via_id]`` (see ``EHLIndex.pack_region``), so the shared
    vertex table replaces it exactly.
    """
    hub, _, d, vid = arrs
    R = hub.shape[0]
    zeros = np.zeros(R, np.int32)
    hub_q, hub_base = torch.from_numpy(hub), zeros
    vid_q, vid_base = torch.from_numpy(vid), zeros
    if layout.ids == "u16":
        enc, base = encode_delta_u16(hub, hub != HUB_PAD)
        if enc is not None:
            hub_q, hub_base = _u16_tensor(enc), base
        enc, base = encode_delta_u16(vid, vid >= 0)
        if enc is not None:
            vid_q, vid_base = _u16_tensor(enc), base
    d_q, qerr = torch.from_numpy(d), 0.0
    if layout.dist != "f32":
        dq, err = encode_dist(d, layout.dist_dtype)
        if dq is not None:
            d_q, qerr = dq, err
    return (hub_q, d_q, vid_q, torch.from_numpy(hub_base),
            torch.from_numpy(vid_base), qerr)


def _quant_stats(layout: SlabLayout, hub_ids, via_d, via_ids, qerr) -> dict:
    """Per-bucket realized encoding + fallback flags (never silent)."""
    return dict(
        layout=layout,
        qerr=(float(qerr) if qerr is not None else 0.0),
        id_fallback=tuple(h.dtype != U16_STORAGE for h in hub_ids)
        if layout.ids == "u16" else (),
        vid_fallback=tuple(v.dtype != U16_STORAGE for v in via_ids)
        if layout.ids == "u16" else (),
        dist_fallback=tuple(d.dtype != layout.dist_dtype for d in via_d)
        if layout.dist != "f32" else ())


def _vert_table(index: EHLIndex) -> np.ndarray:
    """[V, 2] f32 shared vertex table — exactly the values the f32 packer
    wrote per slot (``via_xy = graph.nodes[via]`` cast to float32)."""
    return np.asarray(index.graph.nodes, np.float32)


def _cell_mapper(index: EHLIndex, live: list) -> np.ndarray:
    """[C] int32 cell -> dense index into the live-region ordering."""
    row_of = {rid: i for i, rid in enumerate(live)}
    mapper = np.zeros(index.mapper.size, dtype=np.int32)
    for ci, rid in enumerate(index.mapper):
        mapper[ci] = row_of[int(rid)]
    return mapper


def _pack_edges(scene_or_index, lane: int, mask: np.ndarray | None = None):
    """Pack (a, b, c) edge arrays, degenerate-padded with >= 1 sentinel.

    ``mask`` selects an edge subset (the per-shard clip), order preserved.
    Every padding slot is the degenerate triple (a == b == c), provably
    non-blocking under the §5 predicate for every query segment.
    """
    scene = getattr(scene_or_index, "scene", scene_or_index)
    edges = scene.edges
    enext = scene.edge_next
    if mask is not None:
        edges = edges[mask]
        enext = enext[mask]
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


def _grid_plan(ea: np.ndarray, eb: np.ndarray, num_real: int, scene,
               edge_grid: bool | None):
    """The plan ``(gnx, gny, gcell, M)`` of the edge grid the packer
    attaches, or None for the dense path; host arithmetic only.

    ``edge_grid=None`` (auto) attaches the grid only when the per-segment
    gathered tile (``3 * max(gnx, gny) * M`` slots) is smaller than the
    dense edge list.  ``True``/``False`` force.
    """
    if edge_grid is False:
        return None
    plan = plan_grid(ea, eb, num_real, scene.width, scene.height)
    gnx, gny, _, M = plan
    if edge_grid is None and 3 * max(gnx, gny) * M >= ea.shape[0]:
        return None
    return plan


def _maybe_grid(ea: np.ndarray, eb: np.ndarray, num_real: int, scene,
                edge_grid: bool | None, dev: torch.device) -> EdgeGrid | None:
    """Build the edge grid when :func:`_grid_plan` attaches one; it decides
    before anything is built."""
    if _grid_plan(ea, eb, num_real, scene, edge_grid) is None:
        return None
    return build_edge_grid(ea, eb, num_real, scene.width, scene.height,
                           sentinel=ea.shape[0] - 1, device=dev)


def _grid_bytes(index: EHLIndex, lane: int, edge_grid: bool | None) -> int:
    """``device_bytes()`` of the grid the packer would attach, without
    building it (the grid term of :func:`bucketed_device_bytes`)."""
    ea, eb, _ = _pack_edges(index, lane)
    plan = _grid_plan(ea, eb, index.scene.edges.shape[0], index.scene,
                      edge_grid)
    return 0 if plan is None else ell_bytes(plan[0], plan[1], plan[3])


def slab_label_slots(index: EHLIndex, lane: int = 128,
                     region_pad_multiple: int = 1) -> tuple[int, int]:
    """(used, total) label slots of the would-be single slab, analytically."""
    counts = index.packed_label_counts()
    R = _round_up(max(1, len(counts)), region_pad_multiple)
    L = _round_up(max(1, int(counts.max(initial=1))), lane)
    return int(counts.sum()), R * L


def slab_device_bytes(index: EHLIndex, lane: int = 128,
                      region_pad_multiple: int = 1,
                      edge_grid: bool | None = None,
                      layout: SlabLayout = LAYOUT_F32) -> int:
    """What ``pack_index(...).device_bytes()`` would be, without packing."""
    _, slots = slab_label_slots(index, lane, region_pad_multiple)
    lb = dtype_bytes(layout)
    R = _round_up(max(1, len(index.packed_label_counts())),
                  region_pad_multiple)
    Ep = padded_edge_count(index.scene.edges.shape[0], lane)
    return (slots * lb.per_slot + R * lb.per_row
            + index.graph.num_nodes * lb.per_vertex
            + index.mapper.size * 4 + 3 * Ep * 2 * 4
            + _grid_bytes(index, lane, edge_grid))


def pack_index(index: EHLIndex, lane: int = 128,
               region_pad_multiple: int = 1,
               edge_grid: bool | None = None,
               layout: SlabLayout = LAYOUT_F32,
               device="cuda") -> PackedIndex:
    """Freeze a (possibly compressed) host index into one slab on ``device``.

    Rows are padded to the largest label count rounded up to ``lane``, and
    the row count to a multiple of ``region_pad_multiple``.  ``edge_grid``:
    ``None`` attaches the §10 edge grid when pruning pays, ``True``/
    ``False`` force it on/off.  ``layout``: quantized layouts store
    distances narrow, ids u16-delta, drop ``via_xy`` for the shared vertex
    table, and attach the host-side :class:`ResidualTable` the exact-argmin
    rescue reads (DESIGN.md §11).
    """
    dev = resolve_device(device)
    live, packs = _host_packs(index)
    R = _round_up(len(live), region_pad_multiple)
    Lmax = max((len(p["hubs"]) for p in packs), default=1)
    L = _round_up(max(Lmax, 1), lane)
    arrs = _alloc_slab(R, L)
    for i, p in enumerate(packs):
        _fill_row(arrs, i, p)

    mapper = _cell_mapper(index, live)
    ea, eb, ec = _pack_edges(index, lane)
    grid = _maybe_grid(ea, eb, index.scene.edges.shape[0], index.scene,
                       edge_grid, dev)

    def put(a):
        return _put(a, dev)

    common = dict(mapper=put(mapper), edges_a=put(ea), edges_b=put(eb),
                  edges_c=put(ec), grid=grid, nx=int(index.nx),
                  ny=int(index.ny), cell_size=float(index.cell_size),
                  width=float(index.scene.width),
                  height=float(index.scene.height))
    if not layout.quantized:
        return PackedIndex(hub_ids=put(arrs[0]), via_xy=put(arrs[1]),
                           via_d=put(arrs[2]), via_ids=put(arrs[3]),
                           **common)
    hub_q, d_q, vid_q, hb, vb, qerr = _quantize_slab(arrs, layout)
    residual = ResidualTable(
        (arrs[2],), np.zeros(R, np.int32), np.arange(R, dtype=np.int32),
        mapper, (L,), index.nx, index.ny, float(index.cell_size))
    return PackedIndex(
        hub_ids=put(hub_q), via_xy=None, via_d=put(d_q), via_ids=put(vid_q),
        vert_xy=put(_vert_table(index)), hub_base=put(hb), vid_base=put(vb),
        qerr=torch.tensor(float(qerr), dtype=torch.float32, device=dev),
        layout=layout, residual=residual, **common)


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


def bucketed_device_bytes(index: EHLIndex, lane: int = 128,
                          edge_grid: bool | None = None,
                          layout: SlabLayout = LAYOUT_F32) -> int:
    """What ``pack_bucketed(...).device_bytes()`` would be, without packing."""
    counts, widths, region_bucket = plan_buckets(index, lane)
    lb = dtype_bytes(layout)
    slabs = sum(max(1, int((region_bucket == k).sum()))
                * (w * lb.per_slot + lb.per_row)
                for k, w in enumerate(widths))
    Ep = padded_edge_count(index.scene.edges.shape[0], lane)
    return (slabs + index.graph.num_nodes * lb.per_vertex
            + index.mapper.size * 4 + 2 * len(counts) * 4
            + 3 * Ep * 2 * 4 + _grid_bytes(index, lane, edge_grid))


def pack_bucketed(index: EHLIndex, lane: int = 128,
                  reuse_edges_from: "BucketedIndex | PackedIndex | None" = None,
                  edge_grid: bool | None = None,
                  layout: SlabLayout = LAYOUT_F32,
                  device="cuda") -> BucketedIndex:
    """Freeze a host index into width-bucketed slabs on ``device``.

    Each region goes into the smallest power-of-two-multiple-of-``lane``
    bucket that holds its label count, so padding waste is < 50% per region
    instead of being governed by the single largest merged region.

    ``reuse_edges_from``: the repack fast path of the adaptive hot-swap
    loop.  The scene (and so the padded edge tensors and the edge grid built
    from them) never changes across recompressions, so the previous
    artifact's ``edges_a/b/c`` and ``grid`` tensors are aliased, not copied
    or uploaded again.  That artifact must live on ``device``.

    ``edge_grid``: ``None`` attaches the §10 edge grid when pruning pays,
    ``True``/``False`` force it on/off (ignored when reusing: the previous
    artifact's decision carries over with its tensors).

    ``layout``: quantized layouts store distances narrow, ids u16-delta,
    drop ``via_xy`` for the shared vertex table, and attach the host-side
    :class:`ResidualTable` the exact-argmin rescue reads (DESIGN.md §11).
    """
    dev = resolve_device(device)
    if reuse_edges_from is not None and \
            _device_key(reuse_edges_from.device) != _device_key(dev):
        raise ValueError(f"reuse_edges_from lives on "
                         f"{reuse_edges_from.device}, not on {dev}")
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

    edges = None
    if reuse_edges_from is not None:
        edges = (reuse_edges_from.edges_a, reuse_edges_from.edges_b,
                 reuse_edges_from.edges_c)
        ea = eb = ec = None
        grid = reuse_edges_from.grid
    else:
        ea, eb, ec = _pack_edges(index, lane)
        grid = _maybe_grid(ea, eb, index.scene.edges.shape[0], index.scene,
                           edge_grid, dev)
    mapper = _cell_mapper(index, live)
    planes = dict(
        hub_ids=[a[0] for a in slabs], via_xy=[a[1] for a in slabs],
        via_d=[a[2] for a in slabs], via_ids=[a[3] for a in slabs],
        mapper=mapper, region_bucket=region_bucket,
        region_row=region_row, edges_a=ea, edges_b=eb, edges_c=ec,
        nx=index.nx, ny=index.ny, cell_size=index.cell_size,
        width=index.scene.width, height=index.scene.height,
        widths=widths, grid=grid)
    if layout.quantized:
        quant = [_quantize_slab(a, layout) for a in slabs]
        planes.update(
            hub_ids=[q[0] for q in quant], via_xy=[],
            via_d=[q[1] for q in quant], via_ids=[q[2] for q in quant],
            vert_xy=_vert_table(index), hub_base=[q[3] for q in quant],
            vid_base=[q[4] for q in quant],
            qerr=max((q[5] for q in quant), default=0.0), layout=layout,
            residual=ResidualTable(
                [a[2] for a in slabs], region_bucket, region_row, mapper,
                widths, index.nx, index.ny, float(index.cell_size)))
    return _to_device(planes, dev, edges=edges)


_PLANES = ("mapper", "region_bucket", "region_row",
           "edges_a", "edges_b", "edges_c")
_SLABS = ("hub_ids", "via_xy", "via_d", "via_ids")
_GRID_STATIC = ("gnx", "gny", "gcell", "sentinel", "eps")
_DTYPES = dict(hub_ids=np.int32, via_xy=np.float32, via_d=np.float32,
               via_ids=np.int32, mapper=np.int32, region_bucket=np.int32,
               region_row=np.int32, edges_a=np.float32, edges_b=np.float32,
               edges_c=np.float32)
_QUANT_EXTRAS = ("vert_xy", "hub_base", "vid_base", "qerr", "layout")


def _put(a, dev: torch.device) -> torch.Tensor:
    """A plane on ``dev`` in its device storage dtype, never aliasing the
    input: u16 ids as their int16 bits, a 2-byte ``bfloat16`` numpy array
    (another package's bf16, as raw bits) as torch.bfloat16."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, copy=True)
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return _u16_tensor(a).to(dev)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    return torch.as_tensor(np.array(a), device=dev)


def _device_key(dev: torch.device) -> tuple:
    """(type, index) of a device, a bare ``cuda`` read as the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return dev.type, torch.cuda.current_device()
    return dev.type, dev.index


def _to_device(planes: dict, dev: torch.device,
               edges: tuple | None = None) -> BucketedIndex:
    """The artifact of ``planes`` on ``dev``; ``edges``, when given, are
    device tensors ``(edges_a, edges_b, edges_c)`` taken as they are
    (aliased), in place of the planes' own."""
    def put(a):
        return _put(a, dev)

    aliased = {} if edges is None else dict(
        zip(("edges_a", "edges_b", "edges_c"), edges))

    grid = planes.get("grid")
    if isinstance(grid, dict):
        grid = EdgeGrid(cell_ids=put(grid["cell_ids"]),
                        cell_len=put(grid["cell_len"]),
                        gnx=int(grid["gnx"]), gny=int(grid["gny"]),
                        gcell=float(grid["gcell"]),
                        sentinel=int(grid["sentinel"]),
                        eps=float(grid["eps"]))
    extras = {}
    layout = planes.get("layout", LAYOUT_F32)
    if layout.quantized:
        extras = dict(
            vert_xy=put(planes["vert_xy"]),
            hub_base=tuple(put(a) for a in planes["hub_base"]),
            vid_base=tuple(put(a) for a in planes["vid_base"]),
            qerr=torch.tensor(float(planes["qerr"]), dtype=torch.float32,
                              device=dev),
            layout=layout, residual=planes.get("residual"))
    return BucketedIndex(
        **{k: tuple(put(a) for a in planes[k]) for k in _SLABS},
        **{k: aliased[k] if k in aliased else put(planes[k])
           for k in _PLANES},
        nx=int(planes["nx"]), ny=int(planes["ny"]),
        cell_size=float(planes["cell_size"]), width=float(planes["width"]),
        height=float(planes["height"]),
        widths=tuple(int(w) for w in planes["widths"]), grid=grid,
        **extras)


def bucketed_from_numpy(planes: dict, device) -> BucketedIndex:
    """A :class:`BucketedIndex` from another packer's planes, as numpy.

    ``planes`` holds the reference ``repro.core.packed.BucketedIndex``
    fields: every array as a numpy array, the per-bucket slabs as lists of
    them, the static metadata as plain values.  ``grid`` is None or a dict
    of the edge grid's ``cell_ids``/``cell_len`` numpy planes and its static
    fields (``gnx, gny, gcell, sentinel, eps``).  Lets two packages answer
    queries over the very same artifact.

    ``layout`` (optional; a :class:`SlabLayout` or any object with its
    ``dist``/``ids`` fields, such as the reference's) names a quantized
    layout; without it the planes must be the float32 layout.  A quantized
    artifact carries no ``via_xy`` slabs, per bucket ids as uint16 (or int32
    where the packer fell back) and distances in the layout's dtype (or
    float32; ``bfloat16`` as the 2-byte numpy dtype another package
    writes), plus ``vert_xy``, ``hub_base``, ``vid_base`` and ``qerr``, and
    optionally ``residual_d``, the exact float32 distance slabs the rescue
    reads (without it the artifact answers, but cannot rescue argmin rows).
    """
    layout = planes.get("layout")
    layout = (LAYOUT_F32 if layout is None
              else SlabLayout(dist=str(layout.dist), ids=str(layout.ids)))
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
    if layout.quantized:
        return _to_device(_quantized_planes(planes, layout),
                          resolve_device(device))
    for k in _SLABS:
        if len(planes[k]) != len(planes["widths"]):
            raise ValueError(f"{k}: one slab per bucket expected")
    for k, want in _DTYPES.items():
        arrs = planes[k] if k in _SLABS else [planes[k]]
        if any(np.asarray(a).dtype != want for a in arrs):
            raise ValueError(f"{k} must be {np.dtype(want)} (float32 layout)")
    return _to_device(planes, resolve_device(device))


def _quantized_planes(planes: dict, layout: SlabLayout) -> dict:
    """Check a quantized artifact's planes (see :func:`bucketed_from_numpy`)
    and return them with the layout and the residual table attached."""
    missing = {"vert_xy", "hub_base", "vid_base", "qerr"} - set(planes)
    if missing:
        raise ValueError(f"quantized planes lack {sorted(missing)}")
    if len(planes.get("via_xy", ())):
        raise ValueError("quantized planes carry no via_xy slabs (the "
                         "vertex table replaces them)")
    nb = len(planes["widths"])
    ids_ok = ("uint16", "int32") if layout.ids == "u16" else ("int32",)
    dist_ok = ({"bf16": "bfloat16", "f16": "float16",
                "f32": "float32"}[layout.dist], "float32")
    for k, ok in (("hub_ids", ids_ok), ("via_ids", ids_ok),
                  ("via_d", dist_ok), ("hub_base", ("int32",)),
                  ("vid_base", ("int32",))):
        if len(planes[k]) != nb:
            raise ValueError(f"{k}: one slab per bucket expected")
        for a, w in zip(planes[k], planes["widths"]):
            a = np.asarray(a)
            if a.dtype.name not in ok:
                raise ValueError(f"{k} must be one of {ok} under {layout}, "
                                 f"got {a.dtype}")
            if k not in ("hub_base", "vid_base") and (
                    a.ndim != 2 or a.shape[1] != w):
                raise ValueError(f"{k} slabs must be [R_k, {w}]")
    for k in range(nb):
        R = np.asarray(planes["hub_ids"][k]).shape[0]
        for name in ("via_d", "via_ids"):
            if np.asarray(planes[name][k]).shape[0] != R:
                raise ValueError(f"{name}[{k}] must have {R} rows")
        for name in ("hub_base", "vid_base"):
            if np.asarray(planes[name][k]).shape != (R,):
                raise ValueError(f"{name}[{k}] must be [{R}]")
    vert = np.asarray(planes["vert_xy"])
    if vert.dtype != np.float32 or vert.ndim != 2 or vert.shape[1] != 2:
        raise ValueError("vert_xy must be [V, 2] float32")
    for k, want in _DTYPES.items():
        if k not in _SLABS and np.asarray(planes[k]).dtype != want:
            raise ValueError(f"{k} must be {np.dtype(want)}")
    out = dict(planes, via_xy=[], layout=layout, residual=None)
    resid = planes.get("residual_d")
    if resid is not None:
        if len(resid) != nb or any(
                np.asarray(r).dtype != np.float32
                or np.asarray(r).shape != np.asarray(d).shape
                for r, d in zip(resid, planes["via_d"])):
            raise ValueError("residual_d must be one float32 slab per bucket "
                             "of the via_d slabs' shapes")
        out["residual"] = ResidualTable(
            resid, planes["region_bucket"], planes["region_row"],
            planes["mapper"], planes["widths"], planes["nx"], planes["ny"],
            float(planes["cell_size"]))
    return out


# ---------------------------------------------------------------------------
# batched query engine (plain torch; kernels plug in via kernels.ops)
# ---------------------------------------------------------------------------

def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last (x, y) axis, one rounding per op."""
    x, y = v[..., 0], v[..., 1]
    return torch.sqrt(x * x + y * y)


def _scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim tensor on ``device``, written by a fill kernel: no copy from
    host memory, so no stream synchronisation on a CUDA device."""
    return torch.full((), value, dtype=dtype, device=device)


def locate_regions(idx, pts: torch.Tensor) -> torch.Tensor:
    """[B] region ids (bucketed) or slab rows (single slab) for float32
    query points: floor-divide + mapper.

    The divisor is a 0-dim float32 tensor on the points' device.  Divided
    by a Python float (a CPU scalar), a CUDA tensor is multiplied by the
    scalar's float32 reciprocal instead, which at a cell size that is not a
    power of two puts points one ulp below a cell boundary in the next
    cell; the host mirrors (``DeviceEngine._route``,
    :meth:`ResidualTable.locate`) divide, and must agree bit for bit.
    """
    cs = _scalar(idx.cell_size, torch.float32, pts.device)
    ix = torch.clamp((pts[:, 0] / cs).to(torch.int32), 0, idx.nx - 1)
    iy = torch.clamp((pts[:, 1] / cs).to(torch.int32), 0, idx.ny - 1)
    return idx.mapper[(iy * idx.nx + ix).long()]


def _segvis(p, q, bx, use_kernels: bool) -> torch.Tensor:
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


def _decode_ids(enc: torch.Tensor, base: torch.Tensor, pad_val
                ) -> torch.Tensor:
    """u16 delta rows (int16 bits) + per-row bases -> exact int32 ids; an
    int32 slab (the per-bucket fallback) passes through."""
    if enc.dtype != U16_STORAGE:
        return enc
    wide = enc.to(torch.int32)
    raw = base[:, None] + (wide & U16_PAD)
    return torch.where(wide == -1, torch.full_like(raw, int(pad_val)), raw)


def _via_xy_of(vid: torch.Tensor, vert_xy: torch.Tensor) -> torch.Tensor:
    """The per-slot via coordinates from the shared vertex table.

    Bitwise-equal to the f32 layout's ``via_xy`` plane: the packer writes
    ``graph.nodes[via]`` (cast f32) per slot and zeros for pads, which is
    exactly ``vert_xy[vid]`` masked at ``vid < 0``.
    """
    xy = vert_xy[torch.clamp(vid, 0, vert_xy.shape[0] - 1).long()]
    return torch.where((vid >= 0)[..., None], xy, torch.zeros_like(xy))


def _gather_packed(idx: PackedIndex, rows: torch.Tensor):
    """Gather per-query label rows of the single slab (its full width);
    quantized rows are decoded as :func:`_gather_bucketed` decodes them."""
    rows = rows.long()
    if not idx.layout.quantized:
        return (idx.hub_ids[rows], idx.via_xy[rows], idx.via_d[rows],
                idx.via_ids[rows])
    hub = _decode_ids(idx.hub_ids[rows], idx.hub_base[rows], HUB_PAD)
    vid = _decode_ids(idx.via_ids[rows], idx.vid_base[rows], -1)
    return (hub, _via_xy_of(vid, idx.vert_xy),
            idx.via_d[rows].to(torch.float32), vid)


def _gather_bucketed(bx: BucketedIndex, regions: torch.Tensor, bucket: int,
                     width: int | None = None):
    """Gather per-query labels from buckets <= ``bucket``, padded to its width.

    Regions living in a *wider* bucket than ``bucket`` come back as pure
    padding (HUB_PAD / inf) — the caller dispatches each query at the max
    of its endpoint buckets.  ``width`` (>= ``widths[bucket]``) pads the
    gather beyond the bucket's own width with inert HUB_PAD/inf slots (the
    rescue gathers at a given width).  Quantized slabs are decoded here:
    ids back to exact int32 against the row bases, via coordinates from the
    shared vertex table, distances widened to float32, so everything
    downstream is the f32 layout's code.
    """
    W = bx.widths[bucket] if width is None else width
    B = regions.shape[0]
    dev = regions.device
    hub = torch.full((B, W), int(HUB_PAD), dtype=torch.int32, device=dev)
    xy = torch.zeros((B, W, 2), dtype=torch.float32, device=dev)
    vd = torch.full((B, W), float("inf"), dtype=torch.float32, device=dev)
    vid = torch.full((B, W), -1, dtype=torch.int32, device=dev)

    regions = regions.long()
    src_bucket = bx.region_bucket[regions]
    src_row = bx.region_row[regions].long()
    quantized = bx.layout.quantized
    for k in range(bucket + 1):
        w = bx.widths[k]
        rows = torch.clamp(src_row, 0, bx.hub_ids[k].shape[0] - 1)
        sel = src_bucket == k
        if quantized:
            hub_k = _decode_ids(bx.hub_ids[k][rows], bx.hub_base[k][rows],
                                HUB_PAD)
            vid_k = _decode_ids(bx.via_ids[k][rows], bx.vid_base[k][rows],
                                -1)
            xy_k = _via_xy_of(vid_k, bx.vert_xy)
            vd_k = bx.via_d[k][rows].to(torch.float32)
        else:
            hub_k, xy_k, vd_k, vid_k = (bx.hub_ids[k][rows],
                                        bx.via_xy[k][rows],
                                        bx.via_d[k][rows],
                                        bx.via_ids[k][rows])
        hub[:, :w] = torch.where(sel[:, None], hub_k, hub[:, :w])
        xy[:, :w] = torch.where(sel[:, None, None], xy_k, xy[:, :w])
        vd[:, :w] = torch.where(sel[:, None], vd_k, vd[:, :w])
        vid[:, :w] = torch.where(sel[:, None], vid_k, vid[:, :w])
    return hub, xy, vd, vid


def _mask_labels(labels, pts: torch.Tensor, bx, use_kernels: bool):
    """Per-endpoint half of Eq. 1-3: fold via visibility into distances.

    (hub [B,L], xy [B,L,2], d [B,L], vid [B,L]) -> (hub, vd, vid) where
    ``vd`` is inf wherever the via vertex is invisible from the query point.
    """
    hub, xy, d, vid = labels
    B, L = hub.shape
    vis = _segvis(torch.repeat_interleave(pts, L, dim=0), xy.reshape(-1, 2),
                  bx, use_kernels).reshape(B, L)
    inf = _scalar(float("inf"), torch.float32, pts.device)
    vd = torch.where(vis, _norm(pts[:, None] - xy) + d, inf)
    return hub, vd, vid


def _join_masked(masked_s, masked_t, s, t, covis, use_kernels: bool,
                 want_argmin: bool, qerr2=None):
    """Join half of Eq. 1-3 over visibility-masked labels.

    The join emits the row-min form ``rowmin[b,i] = vd_s[b,i] + min_{hub
    match j} vd_t[b,j]`` and the argmin pair is recovered with two O(L)
    reductions (ties resolve to the first index).  ``covis`` overrides with
    the direct Euclidean distance.

    ``qerr2`` (quantized layouts only, with ``want_argmin``): the summed
    per-side quantization error bounds.  A sixth ``amb`` [B] bool output
    flags rows whose argmin margin is within the error bound — their
    winner could differ from the f32 engine's, so the host rescues them
    against the exact residual rows (DESIGN.md §11).  Rows with a unique
    candidate (inf second-best) or no candidate at all (all-inf row) are
    provably unambiguous and excluded.
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

    inf = _scalar(float("inf"), torch.float32, s.device)
    i = torch.argmin(rowmin, dim=-1)                    # [B]
    hub_i = torch.gather(hub_s, 1, i[:, None])          # [B, 1]
    vd_t_match = torch.where(hub_t == hub_i, vd_t, inf)
    j = torch.argmin(vd_t_match, dim=-1)                # [B]
    via_s = torch.gather(vid_s, 1, i[:, None])[:, 0]
    via_t = torch.gather(vid_t, 1, j[:, None])[:, 0]
    if qerr2 is None:
        return d, covis, via_s, hub_i[:, 0], via_t

    # exact-argmin ambiguity: two candidates can swap order in exact f32
    # space only if their quantized margin is within twice the worst-case
    # per-candidate perturbation (qerr2 plus a few ulps of f32 rounding)
    L = rowmin.shape[-1]
    iota = torch.arange(L, device=s.device)[None, :]
    second_i = torch.where(iota == i[:, None], inf, rowmin).amin(dim=-1)
    best_j = torch.gather(vd_t_match, 1, j[:, None])[:, 0]
    second_j = torch.where(iota == j[:, None], inf, vd_t_match).amin(dim=-1)
    eps = torch.finfo(torch.float32).eps
    thr = 2.0 * qerr2 + (64.0 * eps) * torch.abs(d_label)
    amb = ((torch.isfinite(second_i) & (second_i - d_label <= thr))
           | (torch.isfinite(second_j) & (second_j - best_j <= thr)))
    return d, covis, via_s, hub_i[:, 0], via_t, amb


def _layout_key(idx, bucket: int | None) -> tuple:
    """The artifact part of a :data:`TRACES` key: layout, slab or bucket
    width, and the distance dtype stored there (per-bucket fallbacks
    included)."""
    if bucket is None:
        return (idx.layout, "slab", idx.label_width, idx.via_d.dtype)
    return (idx.layout, "bucket", idx.widths[bucket], idx.via_d[bucket].dtype)


@_serving_entry("fold_endpoint")
def _fold_endpoint(idx, pts: torch.Tensor, bucket: int | None = None,
                   use_kernels: bool = False):
    """locate + gather + visibility-fold one endpoint side.

    ``bucket=None`` gathers the single :class:`PackedIndex` slab; an int
    gathers the bucketed layout at that dispatch bucket.
    """
    pts = pts.to(torch.float32)
    TRACES.see("fold_endpoint", pts.device.type, pts.shape[0],
               *_layout_key(idx, bucket))
    r = locate_regions(idx, pts)
    labels = (_gather_packed(idx, r) if bucket is None
              else _gather_bucketed(idx, r, bucket))
    return _mask_labels(labels, pts, idx, use_kernels)


@_serving_entry("join_endpoints")
def _join_endpoints(idx, masked_s, masked_t, s: torch.Tensor,
                    t: torch.Tensor, use_kernels: bool = False,
                    want_argmin: bool = False, qerr2=None):
    """Co-visibility + Eq. 1-3 join over folded endpoint sides."""
    s = s.to(torch.float32)
    t = t.to(torch.float32)
    TRACES.see("join_endpoints", s.device.type, *masked_s[0].shape,
               want_argmin, qerr2 is not None)
    covis = _segvis(s, t, idx, use_kernels)
    return _join_masked(masked_s, masked_t, s, t, covis, use_kernels,
                        want_argmin, qerr2=qerr2)


def device_endpoints(dev: torch.device, s, t) -> tuple:
    """(s, t) as float32 tensors on ``dev``: a host batch is copied there;
    endpoints already there are returned as they are."""
    return (torch.as_tensor(s, dtype=torch.float32, device=dev),
            torch.as_tensor(t, dtype=torch.float32, device=dev))


def query_batch_at_bucket(bx: BucketedIndex, s: torch.Tensor, t: torch.Tensor,
                          bucket: int, use_kernels: bool = False,
                          want_argmin: bool = False):
    """Eq. 1-3 over one dispatch bucket.

    Every query's endpoint regions must live in buckets <= ``bucket`` (i.e.
    ``bucket == max(endpoint buckets)`` after routing).  Returns d [B]
    float32, or with ``want_argmin`` (d, covis, via_s, hub, via_t), and on a
    quantized layout a sixth ``amb`` [B] bool: the rows to rescue
    (:func:`rescue_exact`).
    """
    s, t = device_endpoints(bx.device, s, t)
    ms = _fold_endpoint(bx, s, bucket, use_kernels=use_kernels)
    mt = _fold_endpoint(bx, t, bucket, use_kernels=use_kernels)
    qerr2 = (bx.qerr + bx.qerr
             if bx.layout.quantized and want_argmin else None)
    return _join_endpoints(bx, ms, mt, s, t, use_kernels=use_kernels,
                           want_argmin=want_argmin, qerr2=qerr2)


def query_batch(idx: PackedIndex, s, t, use_kernels: bool = False
                ) -> torch.Tensor:
    """Batched Eq. 1-3 over the single slab: [B] float32 distances."""
    s, t = device_endpoints(idx.device, s, t)
    ms = _fold_endpoint(idx, s, use_kernels=use_kernels)
    mt = _fold_endpoint(idx, t, use_kernels=use_kernels)
    return _join_endpoints(idx, ms, mt, s, t, use_kernels=use_kernels)


def query_batch_argmin(idx: PackedIndex, s, t, use_kernels: bool = False):
    """Distances + winning (covis, via_s, hub, via_t) label ids over the
    single slab; a quantized layout adds the sixth ``amb`` [B] bool, the
    rows to rescue (:func:`rescue_exact`)."""
    s, t = device_endpoints(idx.device, s, t)
    ms = _fold_endpoint(idx, s, use_kernels=use_kernels)
    mt = _fold_endpoint(idx, t, use_kernels=use_kernels)
    qerr2 = idx.qerr + idx.qerr if idx.layout.quantized else None
    return _join_endpoints(idx, ms, mt, s, t, use_kernels=use_kernels,
                           want_argmin=True, qerr2=qerr2)


@_serving_entry("join_masked")
def join_masked(masked_s, masked_t, s: torch.Tensor, t: torch.Tensor,
                covis: torch.Tensor, use_kernels: bool = False,
                want_argmin: bool = False, qerr2=None):
    """Eq. 1-3 join over visibility-masked label triples (both sides [B, W])
    with a given co-visibility bit: the join half of
    :func:`query_batch_at_bucket`, which the rescue runs on exact rows.
    ``qerr2``: see :func:`_join_masked`."""
    s = torch.as_tensor(s, dtype=torch.float32, device=masked_s[0].device)
    t = torch.as_tensor(t, dtype=torch.float32, device=masked_s[0].device)
    TRACES.see("join_masked", s.device.type, *masked_s[0].shape,
               want_argmin, qerr2 is not None)
    return _join_masked(masked_s, masked_t, s, t, covis.to(torch.bool),
                        use_kernels, want_argmin, qerr2=qerr2)


# ---------------------------------------------------------------------------
# sharded dispatch primitives (repro_torch.sharding, DESIGN.md §9)
# ---------------------------------------------------------------------------

class _EdgeSet(NamedTuple):
    """An edge set as :func:`_segvis` reads it: one shard's clipped edge
    tensors and their grid, apart from the artifact that holds them."""
    edges_a: torch.Tensor
    edges_b: torch.Tensor
    edges_c: torch.Tensor
    grid: EdgeGrid | None = None


def _width_bucket(bx: BucketedIndex, width: int) -> int:
    """The widest local bucket that fits under a join width."""
    return max((k for k, w in enumerate(bx.widths) if w <= width), default=0)


@_serving_entry("gather_labels_at_width")  # repolint: disable=entry-registry -- library-only full-gather API; no engine calls it, so warmup cannot reach it
def gather_labels_at_width(bx: BucketedIndex, regions: torch.Tensor,
                           width: int):
    """Gather [B] regions' labels as dense [B, width] tensors.

    ``width`` must be >= the widest bucket any of ``regions`` lives in —
    the host router guarantees that by dispatching at ``max(endpoint
    widths)``.
    """
    bucket = _width_bucket(bx, width)
    TRACES.see("gather_labels_at_width", regions.device.type,
               regions.shape[0], width, *_layout_key(bx, bucket))
    return _gather_bucketed(bx, regions, bucket, width)


@_serving_entry("join_gathered")  # repolint: disable=entry-registry -- library-only full-gather API; no engine calls it, so warmup cannot reach it
def join_gathered(labels_s, labels_t, s: torch.Tensor, t: torch.Tensor,
                  edges_a: torch.Tensor, edges_b: torch.Tensor,
                  edges_c: torch.Tensor | None = None,
                  grid: EdgeGrid | None = None, use_kernels: bool = False,
                  want_argmin: bool = False, qerr2=None):
    """Eq. 1-3 over pre-gathered label tensors (both sides [B, W]).

    Single-device convenience form (one edge set answers both sides).  The
    sharded router uses the split-phase entries below instead, so each
    side's visibility runs on the device whose clipped edge set covers it.
    ``qerr2``: see :func:`_join_masked`.
    """
    s = s.to(torch.float32)
    t = t.to(torch.float32)
    TRACES.see("join_gathered", s.device.type, *labels_s[0].shape,
               want_argmin, qerr2 is not None)
    edges = _EdgeSet(edges_a, edges_b,
                     edges_b if edges_c is None else edges_c, grid)
    masked_s = _mask_labels(labels_s, s, edges, use_kernels)
    masked_t = _mask_labels(labels_t, t, edges, use_kernels)
    covis = _segvis(s, t, edges, use_kernels)
    return _join_masked(masked_s, masked_t, s, t, covis, use_kernels,
                        want_argmin, qerr2=qerr2)


@_serving_entry("gather_masked_labels")
def gather_masked_labels(bx: BucketedIndex, regions: torch.Tensor,
                         pts: torch.Tensor, width: int,
                         use_kernels: bool = False):
    """Gather + visibility-fold one endpoint side on its owning shard.

    ``regions`` are the shard's local region ids (the host router's).  The
    owning shard's edge subset is clipped to its owned regions dilated by
    their label reach, which covers every (query point -> via) segment of
    queries located in those regions, so the returned (hub, vd, vid) triple
    is bitwise-identical to the full-edge single-device fold.  For a
    cross-shard query the t-side triple then moves to the s-side device
    ([B, W] tensors, not slabs) for :func:`join_masked`.
    """
    pts = pts.to(torch.float32)
    bucket = _width_bucket(bx, width)
    TRACES.see("gather_masked_labels", pts.device.type, pts.shape[0], width,
               *_layout_key(bx, bucket))
    labels = _gather_bucketed(bx, regions, bucket, width)
    return _mask_labels(labels, pts, bx, use_kernels)


@_serving_entry("covis_blocked")
def covis_blocked(s: torch.Tensor, t: torch.Tensor, edges_a: torch.Tensor,
                  edges_b: torch.Tensor, edges_c: torch.Tensor,
                  grid: EdgeGrid | None = None,
                  use_kernels: bool = False) -> torch.Tensor:
    """[B] int32 — 1 where a *local* edge blocks the direct s->t segment.

    The distributed co-visibility test: each shard whose owned bounding box
    the batch touches answers against its own clipped edges, and the router
    ORs the verdicts — the union of participating clips covers every edge
    the segment can cross, so the OR equals the single-device covis bit.
    """
    s = s.to(torch.float32)
    t = t.to(torch.float32)
    TRACES.see("covis_blocked", s.device.type, s.shape[0], grid is not None)
    vis = _segvis(s, t, _EdgeSet(edges_a, edges_b, edges_c, grid),
                  use_kernels)
    return (~vis).to(torch.int32)


# ---------------------------------------------------------------------------
# quantized layouts: exact-argmin rescue (DESIGN.md §11)
# ---------------------------------------------------------------------------

@_serving_entry("gather_masked_exact")
def gather_masked_exact(idx, pts: torch.Tensor, d_exact: torch.Tensor,
                        width: int, use_kernels: bool = False):
    """Rescue gather: quantized slabs with the exact f32 distance rows.

    ``d_exact`` is the [B, width] residual gather
    (:meth:`ResidualTable.gather_d`) for these points; ``width`` is the
    single slab's ``label_width`` on a :class:`PackedIndex`.  Ids and via
    coordinates decode exactly from the device slabs, so substituting the
    exact distances makes the returned masked triple bitwise-identical to
    the f32 engine's visibility fold — the rescue join then reproduces the
    f32 argmin exactly.
    """
    pts = pts.to(torch.float32)
    TRACES.see("gather_masked_exact", pts.device.type, pts.shape[0], width,
               idx.layout, isinstance(idx, PackedIndex))
    regions = locate_regions(idx, pts)
    if isinstance(idx, PackedIndex):
        hub, xy, _, vid = _gather_packed(idx, regions)
    else:
        bucket = max((k for k, w in enumerate(idx.widths) if w <= width),
                     default=0)
        hub, xy, _, vid = _gather_bucketed(idx, regions, bucket, width)
    return _mask_labels((hub, xy, d_exact.to(torch.float32), vid), pts,
                        idx, use_kernels)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def residual_rows(bx, s, t, width: int) -> tuple:
    """The host half of a rescue: (s, t, ds, dt), the endpoints as float32
    numpy and each side's [B, width] exact distance rows from the
    :class:`ResidualTable` (child span ``rescue.residual`` of a sampled
    request)."""
    res = bx.residual
    if res is None:
        raise ValueError("rescue_exact needs a quantized index with its "
                         "ResidualTable attached")
    with obs.span("rescue.residual", annotate=True):
        s = _host(s).astype(np.float32)
        t = _host(t).astype(np.float32)
        return (s, t, res.gather_d(res.locate(s), width),
                res.gather_d(res.locate(t), width))


def rescue_exact(bx, s, t, width: int, covis, use_kernels: bool = False):
    """Re-answer a batch with exact distances (host residual -> device).

    Full-batch recomputation at the quantized run's shapes; the caller
    splices only the ambiguous rows.  ``covis`` is the quantized run's
    co-visibility bit — pure geometry, identical in both layouts.  Returns
    the exact 5-tuple.  A sampled request's trace gets the child spans
    ``rescue.residual`` (the host rows, :func:`residual_rows`),
    ``rescue.upload`` (their copies) and ``rescue.join`` (the exact gather
    and join enqueued).
    """
    s, t, ds, dt = residual_rows(bx, s, t, width)
    dev = bx.device

    def fold(pts, d):
        # one side's rows on the device only while its gather runs
        with obs.span("rescue.upload"):
            d = torch.from_numpy(d).to(dev)
        with obs.span("rescue.join"):
            return gather_masked_exact(bx, pts, d, width,
                                       use_kernels=use_kernels)

    with obs.span("rescue.upload"):
        st, tt = torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev)
    ms = fold(st, ds)
    mt = fold(tt, dt)
    with obs.span("rescue.join"):
        return join_masked(ms, mt, st, tt, covis, use_kernels=use_kernels,
                           want_argmin=True)


def splice_rescue(quant6, exact5) -> tuple:
    """Host splice: overwrite ambiguous rows of the quantized answers with
    the exact rescue rows.  Returns the engine's plain 5-tuple (numpy)."""
    *quant5, amb = quant6
    outs = [_host(a).copy() for a in quant5]
    m = _host(amb)
    exact5 = [_host(e) for e in exact5]
    with obs.annotate("rescue.splice"):     # host only: the reads are done
        for o, e in zip(outs, exact5):
            o[m] = e[m]
    return tuple(outs)


# ---------------------------------------------------------------------------
# the cross-shard quantized wire (DESIGN.md §9/§11)
# ---------------------------------------------------------------------------

def wire_dtypes(bx: BucketedIndex) -> tuple:
    """(id dtype, distance dtype) of the cross-shard quantized wire.

    Unified per artifact: if *any* bucket fell back to raw int32 ids (range
    overflow) the whole wire ships int32, decoded; likewise any float32
    distance fallback widens the distance plane.  u16 ids ship as their
    device storage (``U16_STORAGE``, the int16 bits), so one wire dtype
    serves every bucket mix.
    """
    id_dt = U16_STORAGE
    for arr in (*bx.hub_ids, *bx.via_ids):
        if arr.dtype != U16_STORAGE:
            id_dt = torch.int32
    dist_dt = bx.layout.dist_dtype
    for arr in bx.via_d:
        if arr.dtype != dist_dt:
            dist_dt = torch.float32
    return id_dt, dist_dt


def _gather_quant_plane(slabs, bases, src_bucket, src_row, widths,
                        bucket: int, W: int, wire_i32: bool, pad_raw,
                        B: int):
    """One id plane of the quantized wire gather (hub or via): encoded rows
    and their bases, or decoded int32 rows (bases 0) on an int32 wire."""
    dev = src_bucket.device
    if wire_i32:
        enc = torch.full((B, W), int(pad_raw), dtype=torch.int32, device=dev)
    else:
        enc = torch.full((B, W), -1, dtype=U16_STORAGE, device=dev)
    base = torch.zeros((B,), dtype=torch.int32, device=dev)
    for k in range(bucket + 1):
        w = widths[k]
        rows = torch.clamp(src_row, 0, slabs[k].shape[0] - 1)
        sel = src_bucket == k
        if wire_i32:
            plane = _decode_ids(slabs[k][rows], bases[k][rows], pad_raw)
        else:
            plane = slabs[k][rows]
            base = torch.where(sel, bases[k][rows], base)
        enc[:, :w] = torch.where(sel[:, None], plane, enc[:, :w])
    return enc, base


@_serving_entry("gather_quant_rows")
def gather_quant_rows(bx: BucketedIndex, regions: torch.Tensor,
                      pts: torch.Tensor, width: int,
                      use_kernels: bool = False):
    """Owner-side half of the quantized cross-shard gather.

    Ships the *encoded* label rows — (hub_enc, hub_base, dq, via_enc,
    via_base, vis) — instead of the decoded float32 masked triple, cutting
    the wire from 12 to ~7 bytes per slot.  The visibility verdict is
    computed here (the owner holds the clipped edge set); the decode and
    the distance sum happen on the joining device
    (:func:`dequant_masked_labels`), which reproduces the owner-side fold
    bit for bit (same expression, same input bits).
    """
    pts = pts.to(torch.float32)
    bucket = _width_bucket(bx, width)
    TRACES.see("gather_quant_rows", pts.device.type, pts.shape[0], width,
               *_layout_key(bx, bucket))
    id_dt, dist_dt = wire_dtypes(bx)
    wire_i32 = id_dt == torch.int32
    regions = regions.long()
    src_bucket = bx.region_bucket[regions]
    src_row = bx.region_row[regions].long()
    B = regions.shape[0]
    henc, hbase = _gather_quant_plane(
        bx.hub_ids, bx.hub_base, src_bucket, src_row, bx.widths, bucket,
        width, wire_i32, HUB_PAD, B)
    venc, vbase = _gather_quant_plane(
        bx.via_ids, bx.vid_base, src_bucket, src_row, bx.widths, bucket,
        width, wire_i32, -1, B)
    dq = torch.full((B, width), float("inf"), dtype=dist_dt,
                    device=pts.device)
    for k in range(bucket + 1):
        w = bx.widths[k]
        rows = torch.clamp(src_row, 0, bx.via_d[k].shape[0] - 1)
        sel = src_bucket == k
        dq[:, :w] = torch.where(sel[:, None], bx.via_d[k][rows].to(dist_dt),
                                dq[:, :w])
    vid = _decode_ids(venc, vbase, -1)
    xy = _via_xy_of(vid, bx.vert_xy)
    vis = _segvis(torch.repeat_interleave(pts, width, dim=0),
                  xy.reshape(-1, 2), bx, use_kernels).reshape(B, width)
    return henc, hbase, dq, venc, vbase, vis


@_serving_entry("dequant_masked_labels")
def dequant_masked_labels(henc, hbase, dq, venc, vbase, vis,
                          pts: torch.Tensor, vert_xy: torch.Tensor):
    """Joining-device half: decode shipped quantized rows into the masked
    triple — the same ``where(vis, norm + d, inf)`` expression as the
    owner-side fold (:func:`_mask_labels`), so the result is
    bitwise-identical to having shipped the decoded rows."""
    pts = pts.to(torch.float32)
    TRACES.see("dequant_masked_labels", pts.device.type, *henc.shape,
               henc.dtype, dq.dtype)
    hub = _decode_ids(henc, hbase, HUB_PAD)
    vid = _decode_ids(venc, vbase, -1)
    xy = _via_xy_of(vid, vert_xy)
    inf = _scalar(float("inf"), torch.float32, pts.device)
    vd = torch.where(vis, _norm(pts[:, None] - xy) + dq.to(torch.float32),
                     inf)
    return hub, vd, vid


# ---------------------------------------------------------------------------
# the split packer: per-shard slabs and clipped edges (DESIGN.md §9/§10)
# ---------------------------------------------------------------------------

def _region_clip_boxes(index: EHLIndex, live: list, packs: list,
                       cell_region: np.ndarray) -> np.ndarray:
    """[R, 4] per-region visibility-reach boxes (xmin, ymin, xmax, ymax).

    The box spans the region's own cells *and* every via vertex its labels
    reach: any (query point -> via) segment of a query located in the
    region stays inside the box (a segment lies in the bounding box of its
    endpoints), and so does the region-local part of any s->t segment.
    Dilated by a small slack so float32 sign tests on nearly-touching
    edges can never disagree with the clip.
    """
    R = len(live)
    cs = float(index.cell_size)
    iy, ix = np.divmod(np.arange(index.mapper.size), index.nx)
    boxes = np.full((R, 4), np.inf)
    boxes[:, 2:] = -np.inf
    np.minimum.at(boxes[:, 0], cell_region, ix * cs)
    np.minimum.at(boxes[:, 1], cell_region, iy * cs)
    np.maximum.at(boxes[:, 2], cell_region, (ix + 1) * cs)
    np.maximum.at(boxes[:, 3], cell_region, (iy + 1) * cs)
    for r, p in enumerate(packs):
        xy = p["via_xy"]
        if len(xy):
            boxes[r, 0] = min(boxes[r, 0], xy[:, 0].min())
            boxes[r, 1] = min(boxes[r, 1], xy[:, 1].min())
            boxes[r, 2] = max(boxes[r, 2], xy[:, 0].max())
            boxes[r, 3] = max(boxes[r, 3], xy[:, 1].max())
    slack = 1e-3 * max(index.scene.width, index.scene.height)
    boxes[:, :2] -= slack
    boxes[:, 2:] += slack
    return boxes


def _shard_edge_mask(index: EHLIndex, clip_boxes: np.ndarray,
                     members: np.ndarray) -> np.ndarray:
    """[E] bool — edges whose bbox meets any owned region's clip box."""
    edges = index.scene.edges
    if edges.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    ex0 = np.minimum(edges[:, 0, 0], edges[:, 1, 0])
    ex1 = np.maximum(edges[:, 0, 0], edges[:, 1, 0])
    ey0 = np.minimum(edges[:, 0, 1], edges[:, 1, 1])
    ey1 = np.maximum(edges[:, 0, 1], edges[:, 1, 1])
    bx = clip_boxes[members]                            # [Rk, 4]
    hit = ((ex0[None] <= bx[:, 2:3]) & (ex1[None] >= bx[:, 0:1]) &
           (ey0[None] <= bx[:, 3:4]) & (ey1[None] >= bx[:, 1:2]))
    return hit.any(axis=0)


def pack_bucketed_split(index: EHLIndex, region_shard: np.ndarray,
                        num_shards: int | None = None, lane: int = 128,
                        reuse_edges_from=None, reuse_edge_masks=None,
                        edge_grid: bool | None = None,
                        layout: SlabLayout = LAYOUT_F32, device="cuda"):
    """Freeze a host index into per-shard width-bucketed slabs.

    The shard-aware sibling of :func:`pack_bucketed`: ``region_shard`` maps
    each live region (in live-rid order, as ``packed_label_counts``) to a
    shard; each shard gets its own :class:`BucketedIndex` holding only its
    regions' slabs, with the bucket ladder recomputed from its own label
    counts (a region's bucket *width* is invariant — smallest power-of-two
    multiple of ``lane`` — so sharded join widths match the unsharded
    dispatch widths exactly).

    ``device``: one device, whose type the shards round-robin over
    (``launch.mesh.shard_devices``; ``cuda`` raises without a card), or a
    sequence of one device per shard.  Each shard is packed straight onto
    its own device.

    **Edges are not replicated**: each shard carries only the edges whose
    bounding box meets one of its owned regions' clip boxes (region cells +
    every via vertex its labels reach, slack-dilated) — sufficient for both
    the label-visibility fold of queries it owns and its share of the
    distributed co-visibility test (DESIGN.md §9/§10).  Each subset gets
    its own edge grid per the ``edge_grid`` policy.

    Every shard's mapper covers the full grid; cells owned by other shards
    resolve to local row 0 — harmless, because the host-side routing table
    returned alongside is what decides which shard a query is sent to.

    ``reuse_edges_from`` (+ ``reuse_edge_masks``): previous-generation
    per-shard artifacts and their edge masks — a shard's device-resident
    edge tensors and grid are aliased iff its clip mask is unchanged (the
    recompression may have changed label reach, so masks are compared, not
    assumed); an aliased shard must already live on its device.

    Returns ``(shards, route)``: the per-shard ``BucketedIndex`` list plus
    the host-side routing table — cell arrays (``cell_shard``,
    ``cell_local``, ``cell_bucket``, ``cell_row``, ``cell_width``) and the
    per-shard ``edge_mask`` list and owned bounding ``shard_rects`` the
    router's distributed covis test uses.
    """
    from repro_torch.launch.mesh import shard_devices

    live, packs = _host_packs(index)
    R = len(live)
    region_shard = np.asarray(region_shard, dtype=np.int32)
    if region_shard.shape != (R,):
        raise ValueError(f"region_shard has shape {region_shard.shape}, "
                         f"index has {R} live regions")
    S = int(num_shards) if num_shards is not None \
        else int(region_shard.max(initial=-1)) + 1
    if isinstance(device, (list, tuple)):
        devices = shard_devices(device, S)
    else:
        devices = shard_devices(None, S, device=device)
    counts = index.packed_label_counts()
    if reuse_edges_from is None or hasattr(reuse_edges_from, "edges_a"):
        reuse_edges_from = [reuse_edges_from] * S
    if reuse_edge_masks is None:
        reuse_edge_masks = [None] * S

    # global region -> (local id, local bucket, local row) within its shard
    region_local = np.zeros(R, dtype=np.int32)
    region_lbucket = np.zeros(R, dtype=np.int32)
    region_lrow = np.zeros(R, dtype=np.int32)
    region_width = np.array([bucket_width(max(1, int(c)), lane)
                             for c in counts], dtype=np.int32)
    cell_region = _cell_mapper(index, live)
    clip_boxes = _region_clip_boxes(index, live, packs, cell_region)

    shards, edge_masks, shard_rects = [], [], np.zeros((S, 4))
    for k, dev in enumerate(devices):
        members = np.nonzero(region_shard == k)[0]
        if members.size == 0:
            raise ValueError(f"shard {k} owns no regions — plan fewer "
                             "shards or rebalance")
        region_local[members] = np.arange(members.size, dtype=np.int32)
        widths_k = sorted({int(region_width[i]) for i in members})
        bucket_of_width = {w: b for b, w in enumerate(widths_k)}
        lbucket = np.array([bucket_of_width[int(region_width[i])]
                            for i in members], dtype=np.int32)
        lrow = np.zeros(members.size, dtype=np.int32)
        slab_members: list[list[int]] = [[] for _ in widths_k]
        for li, gi in enumerate(members):
            b = lbucket[li]
            lrow[li] = len(slab_members[b])
            slab_members[b].append(int(gi))
        region_lbucket[members] = lbucket
        region_lrow[members] = lrow

        slabs = []
        for b, w in enumerate(widths_k):
            arrs = _alloc_slab(max(1, len(slab_members[b])), w)
            for row, gi in enumerate(slab_members[b]):
                _fill_row(arrs, row, packs[gi])
            slabs.append(arrs)

        mask = _shard_edge_mask(index, clip_boxes, members)
        edge_masks.append(mask)
        # owned bounding rect: which batches this shard's covis test covers
        cells_k = np.nonzero(region_shard[cell_region] == k)[0]
        iy, ix = np.divmod(cells_k, index.nx)
        cs = float(index.cell_size)
        shard_rects[k] = (ix.min() * cs, iy.min() * cs,
                          (ix.max() + 1) * cs, (iy.max() + 1) * cs)

        reuse = reuse_edges_from[k]
        prev_mask = reuse_edge_masks[k]
        edges = None
        if reuse is not None and prev_mask is not None \
                and np.array_equal(prev_mask, mask):
            if _device_key(reuse.device) != _device_key(dev):
                raise ValueError(f"shard {k}: reuse_edges_from lives on "
                                 f"{reuse.device}, not on {dev}")
            edges = (reuse.edges_a, reuse.edges_b, reuse.edges_c)
            ea = eb = ec = None
            grid = reuse.grid
        else:
            ea, eb, ec = _pack_edges(index, lane, mask=mask)
            grid = _maybe_grid(ea, eb, int(mask.sum()), index.scene,
                               edge_grid, dev)

        # full-grid mapper: owned cells -> local id, foreign cells -> 0
        mapper_k = np.where(region_shard[cell_region] == k,
                            region_local[cell_region], 0).astype(np.int32)
        planes = dict(
            hub_ids=[a[0] for a in slabs], via_xy=[a[1] for a in slabs],
            via_d=[a[2] for a in slabs], via_ids=[a[3] for a in slabs],
            mapper=mapper_k, region_bucket=lbucket, region_row=lrow,
            edges_a=ea, edges_b=eb, edges_c=ec, nx=index.nx, ny=index.ny,
            cell_size=index.cell_size, width=index.scene.width,
            height=index.scene.height, widths=widths_k, grid=grid)
        if layout.quantized:
            quant = [_quantize_slab(a, layout) for a in slabs]
            planes.update(
                hub_ids=[q[0] for q in quant], via_xy=[],
                via_d=[q[1] for q in quant], via_ids=[q[2] for q in quant],
                vert_xy=_vert_table(index), hub_base=[q[3] for q in quant],
                vid_base=[q[4] for q in quant],
                qerr=max((q[5] for q in quant), default=0.0), layout=layout,
                residual=ResidualTable(
                    [a[2] for a in slabs], lbucket, lrow, mapper_k,
                    widths_k, index.nx, index.ny, float(index.cell_size)))
        shards.append(_to_device(planes, dev, edges=edges))

    route = dict(
        region_shard=region_shard,
        region_local=region_local,
        cell_region=cell_region,
        cell_shard=region_shard[cell_region],
        cell_local=region_local[cell_region],
        cell_bucket=region_lbucket[cell_region],
        cell_row=region_lrow[cell_region],
        cell_width=region_width[cell_region],
        edge_mask=edge_masks,
        shard_rects=shard_rects)
    return shards, route


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
        if want_argmin and bx.layout.quantized:
            # 6-tuple: rescue ambiguous-margin rows against the residual
            if bool(res[5].any()):
                exact = rescue_exact(bx, s[m], t[m], bx.widths[int(k)],
                                     res[1], use_kernels=use_kernels)
                res = splice_rescue(res, exact)
            else:
                res = res[:5]
        for o, r in zip(outs, res if want_argmin else (res,)):
            o[m] = _host(r)
    return tuple(outs) if want_argmin else outs[0]


def empty_results(n: int, want_argmin: bool) -> list:
    """Output buffers matching the engine dtypes: d [+ covis, label ids]."""
    if not want_argmin:
        return [np.empty(n, np.float32)]
    return [np.empty(n, np.float32), np.empty(n, bool),
            np.empty(n, np.int32), np.empty(n, np.int32),
            np.empty(n, np.int32)]
