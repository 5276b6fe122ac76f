"""Spatially-bucketed obstacle edges: the O(L·E) -> O(L·E_local) path.

The port's own copy of the reference's edge grid (DESIGN.md §10).  The
query-phase visibility predicate tests every candidate segment against
every obstacle edge — O(L·E) per query.  :class:`EdgeGrid` rasterizes the
packed edge tensors into a uniform cell grid (ELL layout: per-cell edge-id
lists, padded with a degenerate *sentinel* edge id), and the query side
walks only the cells a segment passes through, gathering per-segment edge
tiles for the same OR-reduction (``kernels.segvis_tiles`` /
``ref.segvis_tiles_ref``).

Correctness is a *superset* argument, so grid pruning is bitwise-identical
to the dense predicate by construction:

* every edge is registered in every cell its bounding box overlaps (host
  float64, exact);
* the walk visits every cell the segment touches, dilated by ``eps`` (a
  1e-3 fraction of a cell) so float32 clipping arithmetic on the device can
  never round a visited cell away;
* any edge that blocks a segment intersects it, the intersection point
  lies in a cell both registered for the edge and visited by the walk, so
  the edge id is always gathered; every gathered edge evaluates the exact
  same per-(segment, edge) predicate as the dense path, and extra gathered
  edges contribute ``False`` to the OR.

The walk is a dominant-axis column scan in fixed shapes: at most
``max(gnx, gny)`` columns, at most 3 rows per column (cells are square and
the minor-axis slope is <= 1), so every segment visits <= ``3*max(gnx,gny)``
cell slots.  It is written one torch op per step of the reference's walk,
in the same order, so the cell ids come out identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EdgeGrid:
    """Uniform-cell edge buckets over the packed edge tensors.

    ``cell_ids[c]`` lists the edge ids whose bounding box overlaps cell
    ``c`` (row-major, ``iy * gnx + ix``), padded to the ELL width ``M``
    with ``sentinel`` — the id of a degenerate (a == b == c) slot in the
    packed edge tensors, which the §5 predicate can never block on.  Row
    ``gnx * gny`` is the all-sentinel row that out-of-walk cell slots
    resolve to.
    """

    cell_ids: torch.Tensor      # [C+1, M] int32 edge ids, sentinel padded
    cell_len: torch.Tensor      # [C+1] int32 real ids per cell (stats)
    # static metadata
    gnx: int
    gny: int
    gcell: float                # exactly representable in float32
    sentinel: int               # padding edge id (degenerate packed slot)
    eps: float                  # walk dilation, world units

    # -- properties ----------------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.gnx * self.gny

    @property
    def ell_width(self) -> int:
        return self.cell_ids.shape[1]

    @property
    def walk_slots(self) -> int:
        """Cell slots per segment walk (3 rows x max(gnx, gny) columns)."""
        return 3 * max(self.gnx, self.gny)

    @property
    def tile_slots(self) -> int:
        """Edge slots gathered per segment — the padded per-segment cost."""
        return self.walk_slots * self.ell_width

    def device_bytes(self) -> int:
        return int(self.cell_ids.numel() * 4 + self.cell_len.numel() * 4)

    # ------------------------------------------------------------------ walk
    def visited_cells(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """[N, walk_slots] int32 cell ids each segment touches (pad =
        num_cells).

        Dominant-axis column walk: for each grid column the segment's
        bounding box overlaps (dilated by ``eps``), the segment is clipped
        to the column's slab and the minor-axis interval (again dilated)
        yields at most 3 rows.  Every cell containing any point of the
        segment — including points landing exactly on cell boundaries —
        appears in the output; slots beyond the segment's span resolve to
        the empty sentinel row.
        """
        dev = p.device
        f32, i32 = torch.float32, torch.int32
        # 0-dim operands by fill kernels: torch.tensor would copy from
        # pageable host memory and synchronise a CUDA stream
        g = torch.full((), self.gcell, dtype=f32, device=dev)
        eps = torch.full((), self.eps, dtype=f32, device=dev)
        zero_f = torch.full((), 0.0, dtype=f32, device=dev)
        one_f = torch.full((), 1.0, dtype=f32, device=dev)
        gnx, gny = self.gnx, self.gny
        KA = max(gnx, gny)
        px, py = p[:, 0], p[:, 1]
        qx, qy = q[:, 0], q[:, 1]
        dx = qx - px
        dy = qy - py
        swap = dy.abs() > dx.abs()              # dominant axis = y
        u0 = torch.where(swap, py, px)
        u1 = torch.where(swap, qy, qx)
        v0 = torch.where(swap, px, py)
        v1 = torch.where(swap, qx, qy)
        du = u1 - u0
        dv = v1 - v0
        gnx_t = torch.full((), gnx, dtype=i32, device=dev)
        gny_t = torch.full((), gny, dtype=i32, device=dev)
        Gu = torch.where(swap, gny_t, gnx_t)                    # [N]
        Gv = torch.where(swap, gnx_t, gny_t)
        ulo = torch.minimum(u0, u1)
        uhi = torch.maximum(u0, u1)
        zero_i = torch.zeros((), dtype=i32, device=dev)
        col0 = torch.clamp(torch.floor((ulo - eps) / g).to(i32),
                           zero_i, Gu - 1)
        col1 = torch.clamp(torch.floor((uhi + eps) / g).to(i32),
                           zero_i, Gu - 1)
        k = torch.arange(KA, dtype=i32, device=dev)[None, :]
        col = col0[:, None] + k                                 # [N, KA]
        valid_col = col <= col1[:, None]
        # clip to the column's (dilated) u-slab; degenerate du -> whole seg
        slab_lo = col.to(f32) * g - eps
        slab_hi = (col + 1).to(f32) * g + eps
        degen = (du == 0)[:, None]
        safe_du = torch.where(du == 0, one_f, du)[:, None]
        t0 = (slab_lo - u0[:, None]) / safe_du
        t1 = (slab_hi - u0[:, None]) / safe_du
        tlo = torch.where(degen, zero_f,
                          torch.clamp(torch.minimum(t0, t1), 0.0, 1.0))
        thi = torch.where(degen, one_f,
                          torch.clamp(torch.maximum(t0, t1), 0.0, 1.0))
        va = v0[:, None] + tlo * dv[:, None]
        vb = v0[:, None] + thi * dv[:, None]
        vlo = torch.minimum(va, vb) - eps
        vhi = torch.maximum(va, vb) + eps
        r0 = torch.clamp(torch.floor(vlo / g).to(i32), zero_i,
                         Gv[:, None] - 1)
        r1 = torch.clamp(torch.floor(vhi / g).to(i32), zero_i,
                         Gv[:, None] - 1)
        r = r0[:, :, None] + torch.arange(3, dtype=i32, device=dev)[None, None]
        valid = valid_col[:, :, None] & (r <= r1[:, :, None])
        sw = swap[:, None, None]
        ix = torch.where(sw, r, col[:, :, None])
        iy = torch.where(sw, col[:, :, None], r)
        pad = torch.full((), gnx * gny, dtype=i32, device=dev)
        cell = torch.where(valid, iy * gnx + ix, pad)
        return cell.reshape(p.shape[0], KA * 3)

    # ---------------------------------------------------------------- stats
    def edges_touched(self, p, q) -> np.ndarray:
        """[N] real edge slots each segment's walk gathers (bench metric).

        Dense visibility tests every segment against every edge; this is
        the grid path's actual predicate workload (duplicate registrations
        counted — they are evaluated).
        """
        dev = self.cell_ids.device
        cells = self.visited_cells(
            torch.as_tensor(np.asarray(p, np.float32), device=dev),
            torch.as_tensor(np.asarray(q, np.float32), device=dev))
        return self.cell_len[cells.long()].sum(dim=1).cpu().numpy()


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def plan_grid_shape(num_real: int, width: float, height: float,
                    target_cells: int | None = None
                    ) -> tuple[int, int, float]:
    """(gnx, gny, gcell) for ``num_real`` edges over a width x height map.

    Resolution targets ~O(sqrt(E)) cells per axis so mean occupancy stays
    O(1); ``gcell`` is snapped to its float32 value so the host
    rasterization and the device walk divide by the *same* number.
    """
    if target_cells is None:
        target_cells = int(np.clip(
            1 << int(np.ceil(np.log2(max(8.0, np.sqrt(2.0 * max(num_real,
                                                                1)))))),
            8, 64))
    side = max(float(width), float(height))
    gcell = float(np.float32(side / target_cells))
    gnx = max(1, int(np.ceil(width / gcell)))
    gny = max(1, int(np.ceil(height / gcell)))
    return gnx, gny, gcell


def _cell_lists(ea: np.ndarray, eb: np.ndarray, num_real: int,
                gnx: int, gny: int, gcell: float) -> list:
    """Per-cell edge-id lists from exact float64 bounding boxes."""
    lists: list[list[int]] = [[] for _ in range(gnx * gny)]
    a = np.asarray(ea[:num_real], dtype=np.float64)
    b = np.asarray(eb[:num_real], dtype=np.float64)
    if num_real == 0:
        return lists
    x0 = np.clip(np.floor(np.minimum(a[:, 0], b[:, 0]) / gcell), 0,
                 gnx - 1).astype(np.int64)
    x1 = np.clip(np.floor(np.maximum(a[:, 0], b[:, 0]) / gcell), 0,
                 gnx - 1).astype(np.int64)
    y0 = np.clip(np.floor(np.minimum(a[:, 1], b[:, 1]) / gcell), 0,
                 gny - 1).astype(np.int64)
    y1 = np.clip(np.floor(np.maximum(a[:, 1], b[:, 1]) / gcell), 0,
                 gny - 1).astype(np.int64)
    for e in range(num_real):
        for iy in range(y0[e], y1[e] + 1):
            base = iy * gnx
            for ix in range(x0[e], x1[e] + 1):
                lists[base + ix].append(e)
    return lists


def plan_grid(ea: np.ndarray, eb: np.ndarray, num_real: int,
              width: float, height: float,
              target_cells: int | None = None) -> tuple[int, int, float, int]:
    """Host-only grid plan ``(gnx, gny, gcell, ell_width)`` — no device
    tensors, so the packer's attach policy can decide before building."""
    gnx, gny, gcell = plan_grid_shape(num_real, width, height, target_cells)
    lists = _cell_lists(ea, eb, num_real, gnx, gny, gcell)
    M = _round_up(max([len(l) for l in lists], default=0) or 1, 4)
    return gnx, gny, gcell, M


def ell_bytes(gnx: int, gny: int, ell_width: int) -> int:
    """``EdgeGrid.device_bytes()`` of a planned grid: [C+1, M] ids + [C+1]
    lengths, int32."""
    C = gnx * gny
    return (C + 1) * ell_width * 4 + (C + 1) * 4


def plan_grid_bytes(ea: np.ndarray, eb: np.ndarray, num_real: int,
                    width: float, height: float,
                    target_cells: int | None = None) -> int:
    """Exact ``EdgeGrid.device_bytes()`` without building device tensors."""
    gnx, gny, _, M = plan_grid(ea, eb, num_real, width, height, target_cells)
    return ell_bytes(gnx, gny, M)


def build_edge_grid(ea: np.ndarray, eb: np.ndarray, num_real: int,
                    width: float, height: float, sentinel: int,
                    target_cells: int | None = None,
                    device="cuda") -> EdgeGrid:
    """Rasterize packed edge tensors into an :class:`EdgeGrid` on ``device``.

    ``ea``/``eb`` are the *packed* [Ep, 2] arrays (real edges first,
    degenerate padding after); ``sentinel`` is the id of a degenerate
    padding slot — checked here, because every unused ELL slot must be
    provably non-blocking for every query segment.  ``device`` defaults to
    the card and raises without one, as every entry point of the port does
    (``device="cpu"`` asks for the CPU).
    """
    from .packed import resolve_device      # packed imports this module

    dev = resolve_device(device)
    ea = np.asarray(ea)
    eb = np.asarray(eb)
    if not (0 <= sentinel < ea.shape[0]):
        raise ValueError(f"sentinel id {sentinel} outside packed edges "
                         f"[0, {ea.shape[0]})")
    if not np.array_equal(ea[sentinel], eb[sentinel]):
        raise ValueError("sentinel edge must be degenerate (a == b) so "
                         "padding slots can never block")
    gnx, gny, gcell = plan_grid_shape(num_real, width, height, target_cells)
    lists = _cell_lists(ea, eb, num_real, gnx, gny, gcell)
    C = gnx * gny
    M = _round_up(max([len(l) for l in lists], default=0) or 1, 4)
    ids = np.full((C + 1, M), sentinel, dtype=np.int32)
    lens = np.zeros(C + 1, dtype=np.int32)
    for c, l in enumerate(lists):
        ids[c, :len(l)] = l
        lens[c] = len(l)
    return EdgeGrid(cell_ids=torch.as_tensor(ids, device=dev),
                    cell_len=torch.as_tensor(lens, device=dev),
                    gnx=gnx, gny=gny, gcell=gcell, sentinel=int(sentinel),
                    eps=float(np.float32(1e-3 * gcell)))


# ---------------------------------------------------------------------------
# query side
# ---------------------------------------------------------------------------

def gather_edge_tiles(grid: EdgeGrid, ea: torch.Tensor, eb: torch.Tensor,
                      ec: torch.Tensor, p: torch.Tensor, q: torch.Tensor):
    """Per-segment edge tiles: six [N, S] float32 coordinate planes.

    S = ``grid.tile_slots``; unused slots point at the degenerate sentinel
    and contribute nothing to the OR-reduction.
    """
    cells = grid.visited_cells(p, q)                            # [N, K]
    ids = grid.cell_ids[cells.long()].reshape(p.shape[0], -1).long()
    return (ea[ids, 0], ea[ids, 1], eb[ids, 0], eb[ids, 1],
            ec[ids, 0], ec[ids, 1])


def segvis_grid(p: torch.Tensor, q: torch.Tensor, ea: torch.Tensor,
                eb: torch.Tensor, ec: torch.Tensor, grid: EdgeGrid,
                use_kernels: bool = False, chunk: int = 8192) -> torch.Tensor:
    """[N] bool visibility through the edge grid (dense-path bitwise twin).

    Chunks the segment axis so the gathered [chunk, S] tiles bound peak
    memory regardless of batch size (about 45 MB of tiles per chunk at
    S = 192); the bits do not depend on the chunk size.
    """
    from repro_torch.kernels import ops

    fn = ops.segvis_tiles_kernel if use_kernels else ops.segvis_tiles_ref
    N = p.shape[0]
    if N <= chunk:
        return fn(p, q, *gather_edge_tiles(grid, ea, eb, ec, p, q))
    outs = []
    for lo in range(0, N, chunk):
        sl = slice(lo, min(N, lo + chunk))
        outs.append(fn(p[sl], q[sl],
                       *gather_edge_tiles(grid, ea, eb, ec, p[sl], q[sl])))
    return torch.cat(outs)
