#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the Hopper kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch twin (``torch.equal``) at every
shape its path gives it, on contact tables, and on the main path's own
operands (for every rooms-M bucket width W, the first 256 served queries
that dispatch at W: their fold segments and masked label rows), checks
point location at a cell size that is not a power of two (``check: cell
3.0``: rooms-S seed 1 at cell 3.0, points on and one float32 ulp below
every cell boundary, located on the card where the host routing and the
residual table locate them, served within 1e-4 of the float64 oracle),
then drives eight serving paths, each with the launch counts set to 0 just
before it and read just after, and each with a ``warmup:`` line (nvcc
builds, ctypes loads and cold shape keys met on live traffic after
``warmup(paths=True)``, all required to be 0, and the allocator's segment
count before and after):

* the dense main path: rooms-M (seed 0, cell 2.0) compressed to 20% of its
  label memory, packed into width buckets on the card (the auto edge-grid
  policy leaves it dense), served by a ``CudaEngine`` behind
  ``PathServer(batch_size=256)`` for 2000 uniform queries (seed 33) plus
  ``query_paths`` on 64 of them (``segvis`` + ``label_join_rowmin``);
* the single slab: the same index packed by ``pack_index`` (every batch
  at the slab's own width, the largest region's label count rounded up to
  the lane: 384 on rooms-M), whose device bytes must equal
  ``slab_device_bytes`` and whose answers must equal the slab
  ``TorchEngine``'s and the bucketed path's bit for bit; its bf16/u16
  twin is checked once (answers only: distances within 2·qerr of the f32
  slab, winners equal to it after the rescue);
* the dense path through the continuous batcher: the same 2000 queries
  submitted as one-query trickles and as bursts, then flushed and drained
  (split-phase dispatch on CUDA streams), answers equal to the synchronous
  path's bit for bit, distances and argmin;
* the edge-grid path at the default policy: rooms-S (seed 0, cell 2.0,
  budget 0.2), where ``pack_bucketed`` attaches the grid by itself, served
  the same way (``segvis_tiles`` + ``label_join_rowmin``, no dense
  ``segvis``);
* the edge-grid path at the main path's full width: the rooms-M index
  packed with ``edge_grid=True``, whose answers must equal the dense
  path's bit for bit (DESIGN.md §10);
* the quantized path: the same rooms-M index packed with bf16 distances
  and u16 ids (DESIGN.md §11), whose device bytes must equal the byte
  estimator's, whose distances must lie within 2·qerr of the dense path's
  and whose argmin winners, after the residual rescue, must equal the
  dense path's bit for bit;
* the adaptive path (DESIGN.md §8): the uncompressed rooms-M index (the
  main path's graph and hub labels) behind an ``IndexManager`` on the CUDA
  kernels under a device budget of 0.2x its bucketed artifact, served 8
  rounds of 2000 Cluster-2 queries (seed 101, then seed 202 from round 4:
  the workload shifts), the manager adapting after each round and, in the
  shift round, building on its own thread while the continuous batcher
  serves bursts of 250.  Across every swap the probe answers must stay
  bit for bit, the device bytes within the budget, the edge tensors
  aliased, the next live traffic must meet nothing cold and the retired
  artifact's memory must be freed; the final generation must equal its
  twin engine on all 5 outputs, the float64 oracle within 1e-4 and, through
  the batcher, the synchronous path bit for bit.  One line per round
  (phase, us/query, device bytes, generation, and on a swap the decision,
  drift and the host seconds of each build stage) and the join cost of the
  adapted against the uniform-score generation;
* the sharded path (DESIGN.md §9): the main path's index planned onto four
  region shards (``ShardPlanner(4).build``), all on the one card, served by
  a ``ShardedQueryEngine`` on the CUDA kernels behind
  ``PathServer(batch_size=256)``: per-shard lines (device, regions, widths,
  bytes, edges kept by the clip, grid), device bytes equal to
  ``ShardedIndex.device_bytes()``, the per-shard estimate and the
  reference's CPU sizing (2423808 in all), imbalance at most 1.15, answers
  equal to the single-device dense path's and the sharded twin engine's bit
  for bit, the routing line (keys, batches, slot occupancy, cross-shard
  share, covis participants per batch), the batcher against sync, spread
  and profile; then answers only: the bf16/u16 shards (bytes, 2·qerr,
  winners after the rescue, quantized wire rows), the ``edge_grid=True``
  shards (bit-equal to dense, ``segvis_tiles`` launched) and the
  reference's sharded acceptance configuration (rooms-S seed 1 at 0.3, 1000
  queries, then an ``IndexManager(num_shards=4)`` swapping under batcher
  load: answers bit-stable, one generation on all four new shards, no shard
  over its cap, the retired shards' memory freed).  The sharded path's own
  operands (a clipped fold, a covis batch, a home-shard join, a
  clipped-grid tile chunk) join the kernel-versus-twin checks.

Before the adaptive path, the f16 layout is checked once (answers only),
and a fresh rooms-M build is merged to 0.6x the f32 artifact's device
bytes under the bf16 layout (``compress_to_device_budget``) and served.  ``label_join_rowmin``
is also held against its twin with bf16 and f16 distances at every
main-path width.  The answers are checked against the twin engine on the
card (bit for bit) and the float64 host oracle (1e-4, plus 2·qerr on a
quantized artifact).  Prints the card, the build time, per-kernel times
beside the twins' and the bound (counted from what each run's inputs
need: ``pairs_needed``, ``join_bytes``), the ``segvis`` time at every group
size G on the main-path operands, one JSON line of kernel records and,
last, ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
exit code is non-zero and the last line is never printed.  Needs one CUDA
device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.  bound_ms = max(bytes / HBM, ops / F32).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The 67e12 counts an fma as two operations.  The visibility predicate is
# written unfused for bit equality, so one instruction is one operation:
# 132 SMs * 128 float32 lanes * 1.98 GHz boost clock.  Printed beside the
# segvis bound as a note, never used as the bound.
F32_UNFUSED_ISSUE_PER_S = 132 * 128 * 1.98e9
# float32 operations per (segment, edge) pair once the segment's own terms
# (dx, dy, l2, tau, l2 - tau) and the edge's (bx - ax, by - ay) are hoisted
# (csrc/blocked_pairs.cuh): 6 differences to the endpoints, 8 cross
# products, 4 banded signs at 3 operations and 2 compares.  A pair whose
# edge end b lies on the segment's line needs 14 more (the fifth sign and
# the projection); exact contacts only, so the bound leaves them out.
SEGVIS_OPS_PER_PAIR = 6 + 8 + 4 * 5
# a gathered slot is its own edge: the two edge differences per slot too
TILE_OPS_PER_SLOT = SEGVIS_OPS_PER_PAIR + 2
# the dense row join per (i, j) pair: hub compare, select, min
ROWMIN_OPS_PER_PAIR = 3
# the main path (the defaults of the reference's serving example)
MAP, MAP_SEED, CELL, BUDGET = "rooms-M", 0, 2.0, 0.2
BATCH, QUERIES, QUERY_SEED, PATHS, ORACLE = 256, 2000, 33, 64, 256
# the edge-grid path at the default policy (the auto policy attaches there)
GRID_MAP, GRID_SEED = "rooms-S", 0
# segvis_grid's segment chunk: the largest N segvis_tiles is launched at
TILE_CHUNK = 8192
# queries per submit of the async path's bursts
ASYNC_BURST = 250
# the adaptive path (the reference's adaptive demo on the main map): the
# uncompressed index under a device budget of 0.2x its bucketed artifact,
# rounds of Cluster-2 traffic, the workload shifting at the midpoint; the
# shift round's swap is built while the batcher serves bursts
ADAPT_BUDGET, ADAPT_ROUNDS, ADAPT_SEEDS = 0.2, 8, (101, 202)
ADAPT_LOAD_ROUND = ADAPT_ROUNDS // 2
# allocator granularity: every CUDA caching-allocator block is a multiple
ALLOC_ROUND = 512
# the sharded path (DESIGN.md §9): the main path's index over four region
# shards, all on the one card; per-shard device bytes as the reference's
# packer sizes these artifacts on the CPU (f32, edge_grid=True, bf16/u16)
SHARDS, SHARD_TOL = 4, 1.15
SHARD_BYTES = (584720, 577200, 577176, 684712)
SHARD_BYTES_GRID = (589860, 582340, 582316, 689852)
SHARD_BYTES_BF16 = (183232, 184336, 184288, 219664)
# the reference's sharded acceptance configuration: rooms-S seed 1 at
# budget 0.3, 1000 uniform queries (seed 42), batch 64, and an
# IndexManager at 0.5x the bucketed artifact plus the sharding overhead
# swapping under load (Cluster-2 traffic, seed 31)
ACCEPT_SEED, ACCEPT_BUDGET, ACCEPT_QUERIES, ACCEPT_BATCH = 1, 0.3, 1000, 64
ACCEPT_BYTES = (160744, 160728, 160744, 191536)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the stream, between two CUDA
    events around ``reps`` calls: device time plus any gaps the host leaves."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls captured
    in one CUDA graph, replayed ``replays`` times between two CUDA events,
    so the host's launch path is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def profiler():
    import torch

    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CPU, act.CUDA])


def device_times(prof) -> dict:
    """{kernel name: (calls, device microseconds)} of the device-side
    events (kernels, copies) of a ``torch.profiler`` trace."""
    import torch

    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            out[e.key] = (e.count, us)
    return out


def device_ms(fn, reps: int) -> dict:
    """:func:`device_times` of ``reps`` calls of ``fn`` (after one warm
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with profiler() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_times(prof)


def max_abs_err(got, want) -> float:
    """Largest |got - want|, with equal infinities counting as 0."""
    import torch

    got, want = got.float(), want.float()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if bool(same.all()):
        return 0.0
    return float((got - want)[~same].abs().max())


ANSWERS = ("d", "covis", "via_s", "hub", "via_t")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def segvis_inputs(rng, bx, n: int, vertices: np.ndarray, dev):
    """Main-path-like segments: free query points to graph vertices (every
    via segment ends exactly on an obstacle corner)."""
    import torch

    p = rng.uniform(0, [bx.width, bx.height], (n, 2)).astype(np.float32)
    q = vertices[rng.integers(0, len(vertices), n)].astype(np.float32)
    return (torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev),
            bx.edges_a, bx.edges_b, bx.edges_c)


def segvis_case_table(rng, dev):
    """Random segments against random edges, with exact contacts: endpoints
    on edge endpoints, collinear slides, degenerate segments and edges."""
    import torch

    cases = []
    for n, e in ((1, 1), (7, 64), (300, 700), (1000, 128)):
        p, q, a, b, c = (rng.uniform(0, 10, (k, 2)).astype(np.float32)
                         for k in (n, n, e, e, e))
        m = min(n, e)
        q[:m // 3] = a[:m // 3]                     # ends on an edge vertex
        p[m // 3:m // 2] = b[m // 3:m // 2]         # starts on a vertex
        q[m // 2:2 * m // 3] = p[m // 2:2 * m // 3]  # degenerate segment
        b[:e // 4] = a[:e // 4]                     # degenerate edges
        mid = (a[e // 4:e // 2] + b[e // 4:e // 2]) / 2
        k = min(len(mid), n - 2 * m // 3)
        q[2 * m // 3:2 * m // 3 + k] = mid[:k]       # ends on an open edge
        cases.append(tuple(torch.from_numpy(x).to(dev)
                           for x in (p, q, a, b, c)))
    return cases


def tile_inputs(rng, bx, n: int, vertices: np.ndarray, dev):
    """segvis_tiles operands at the grid path's shapes: main-path-like
    segments (free point -> graph vertex) and the six [n, S] planes the
    port's own walk and ELL gather produce for them."""
    import torch

    from repro_torch.core.edgegrid import gather_edge_tiles

    p, q, ea, eb, ec = segvis_inputs(rng, bx, n, vertices, dev)
    return (p, q, *gather_edge_tiles(bx.grid, ea, eb, ec, p, q)), \
        (p, q, ea, eb, ec)


def tile_case_table(rng, dev):
    """Random per-segment tiles with exact contacts: zero-padded slots,
    degenerate edges, endpoints on slot vertices and open slot edges; S = 1
    and S not a multiple of 32 included."""
    import torch

    cases = []
    for n, s in ((1, 1), (7, 33), (300, 600), (1000, 1), (513, 70)):
        p = rng.uniform(0, 10, (n, 2)).astype(np.float32)
        q = rng.uniform(0, 10, (n, 2)).astype(np.float32)
        a, b, c = (rng.uniform(0, 10, (n, s, 2)).astype(np.float32)
                   for _ in range(3))
        pad = rng.random((n, s)) < 0.25
        a[pad] = b[pad] = c[pad] = 0.0              # zero-padded slots
        degen = rng.random((n, s)) < 0.1
        b[degen] = a[degen]                         # degenerate edges
        rows, k = np.arange(n), rng.integers(0, s, n)
        on_vertex = rng.random(n) < 0.3
        q[on_vertex] = a[rows, k][on_vertex]        # ends on a slot vertex
        on_edge = ~on_vertex & (rng.random(n) < 0.4)
        q[on_edge] = ((a[rows, k] + b[rows, k]) / 2)[on_edge]
        planes = [np.ascontiguousarray(x[..., i]) for x in (a, b, c)
                  for i in (0, 1)]
        cases.append(tuple(torch.from_numpy(x).to(dev)
                           for x in [p, q] + planes))
    return cases


def needed(blk) -> int:
    """Entries of a [N, K] blocking matrix an OR over each row must read,
    in index order: up to the row's first True, or all K where none is."""
    import torch

    k = blk.shape[1]
    first = torch.argmax(blk.to(torch.uint8), dim=1) + 1
    return int(torch.where(blk.any(dim=1), first, k).sum())


def slots_needed(args) -> int:
    """Slots the OR over each segment's tile must read on these inputs: up
    to its first blocking slot, or all S where none blocks."""
    from repro_torch.kernels.ref import blocked_pairs

    p, q, *planes = args
    return needed(blocked_pairs(p[:, 0, None], p[:, 1, None], q[:, 0, None],
                                q[:, 1, None], *planes))


def pairs_needed(args, chunk: int = 8192) -> int:
    """(segment, edge) pairs the dense OR must evaluate on these inputs:
    each segment's edges in index order up to its first blocking edge, or
    all of them where none blocks, counting only edges with a != b (a
    degenerate edge never blocks, so no pair with one is needed).  Taken
    ``chunk`` segments at a time."""
    from repro_torch.kernels.ref import blocked_pairs

    p, q, ea, eb, ec = args
    real = (ea != eb).any(dim=1)
    ea, eb, ec = ea[real], eb[real], ec[real]
    edges = (ea[None, :, 0], ea[None, :, 1], eb[None, :, 0], eb[None, :, 1],
             ec[None, :, 0], ec[None, :, 1])
    if not bool(real.any()):
        return 0
    return sum(needed(blocked_pairs(
        p[i:i + chunk, 0, None], p[i:i + chunk, 1, None],
        q[i:i + chunk, 0, None], q[i:i + chunk, 1, None], *edges))
        for i in range(0, p.shape[0], chunk))


def join_bytes(B: int, L: int, dist_bytes: int = 4) -> int:
    """Bytes the sorted row join must move: hub_s, hub_t (4 bytes a label)
    and vd_s, vd_t (``dist_bytes`` a label) read once, the [B, L] float32
    output written once."""
    return 2 * B * L * 4 + 2 * B * L * dist_bytes + B * L * 4


def join_dense_ops(B: int, L: int) -> int:
    """Operations of the dense join: (compare, select, min) per (i, j)."""
    return ROWMIN_OPS_PER_PAIR * B * L * L


def main_path_operands(bx, eng, s, t, B: int) -> dict:
    """The main path's own kernel operands at every bucket: the first B
    queries that ``eng`` routes to bucket k (zero-padded to B, as
    PathServer pads a batch), located, gathered at width W_k and folded as
    the serving path does it.  {W: (fold_s, fold_t, covis, join)}: fold
    segments of each side (N = B*W), the co-visibility segments (N = B), and
    the masked label rows (hub_s, vd_s, hub_t, vd_t) of the join."""
    import torch

    from repro_torch.core.packed import (_gather_bucketed, _mask_labels,
                                         locate_regions)

    dev = bx.device
    edges = (bx.edges_a, bx.edges_b, bx.edges_c)
    buckets = eng.buckets_of(s, t)
    out = {}
    for k, w in enumerate(bx.widths):
        sel = np.nonzero(buckets == k)[0][:B]
        sides, folds, masked = [], [], []
        for pts in (s, t):
            batch = np.zeros((B, 2), np.float32)
            batch[:len(sel)] = pts[sel]
            pts = torch.from_numpy(batch).to(dev)
            labels = _gather_bucketed(bx, locate_regions(bx, pts), k)
            folds.append((torch.repeat_interleave(pts, w, dim=0),
                          labels[1].reshape(-1, 2).contiguous(), *edges))
            hub, vd, _ = _mask_labels(labels, pts, bx, use_kernels=False)
            masked += [hub.contiguous(), vd.contiguous()]
            sides.append(pts)
        out[w] = (folds[0], folds[1], (*sides, *edges), tuple(masked))
    return out


def rowmin_inputs(rng, B: int, L: int, dev, hubs: int = 96):
    """Hub-sorted rows with ties, pads (HUB_PAD, +inf) and invisible vias."""
    import torch

    from repro_torch.core.packed import HUB_PAD

    hs = np.sort(rng.integers(0, hubs, (B, L)), axis=1).astype(np.int32)
    ht = np.sort(rng.integers(0, hubs, (B, L)), axis=1).astype(np.int32)
    vs = rng.integers(0, 400, (B, L)).astype(np.float32) / 4   # many ties
    vt = rng.uniform(0, 100, (B, L)).astype(np.float32)
    vs[rng.random((B, L)) < 0.2] = np.inf
    vt[rng.random((B, L)) < 0.2] = np.inf
    for h, v in ((hs, vs), (ht, vt)):               # padded tails
        for r in range(B):
            k = rng.integers(L // 2, L + 1)
            h[r, k:] = HUB_PAD
            v[r, k:] = np.inf
    return tuple(torch.from_numpy(x).to(dev) for x in (hs, vs, ht, vt))


def cold_state() -> tuple:
    """(cold shape keys, nvcc builds, ctypes loads, allocator segments
    allocated) so far in this process."""
    import torch

    from repro_torch.core.packed import TRACES
    from repro_torch.kernels import build

    return (TRACES.count, sum(build.BUILDS.values()),
            sum(build.LOADS.values()),
            torch.cuda.memory_stats()["segment.all.allocated"])


def report_warmup(what: str, before: tuple) -> None:
    """The ``warmup:`` line: what live traffic met since ``before`` (taken
    just after ``warmup(paths=True)``); builds, loads and cold shape keys
    must all be 0, the allocator's segments are printed."""
    after = cold_state()
    cold, builds, loads = (a - b for a, b in zip(after[:3], before[:3]))
    print(f"warmup: {what}: live traffic after warmup met {builds} builds, "
          f"{loads} loads, {cold} cold shape keys; allocator segments "
          f"allocated {before[3]} -> {after[3]}")
    require(cold == builds == loads == 0,
            f"{what}: live traffic met a build, load or cold shape")


def drive(srv, s, t, index, kernels: dict, twins, label: str) -> dict:
    """One serving path as a user drives it: warmup (argmin path included),
    two ``query`` passes, ``query_paths`` on PATHS.  Every launch count and
    twin call count is set to 0 just before and read just after; the path
    must launch each of ``kernels`` and call no twin, and its live traffic
    must meet nothing cold (``report_warmup``)."""
    import torch

    for k in kernels.values():
        k.launches = 0
    for f in twins:
        f.calls = 0

    def snap(stage):
        stages.append((stage, {n: k.launches for n, k in kernels.items()}))

    stages: list = []
    srv.warmup(paths=True)
    snap("warmup")
    warm = cold_state()
    d_first = srv.query(s, t)
    snap("pass 1")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = srv.query(s, t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap("pass 2")
    dp, paths = srv.query_paths(s[:PATHS], t[:PATHS], host_index=index)
    torch.cuda.synchronize()
    snap("paths")
    report_warmup(label, warm)
    launches = {n: k.launches for n, k in kernels.items()}
    calls = {f.__name__: f.calls for f in twins}
    prev = dict.fromkeys(kernels, 0)
    for stage, now in stages:
        print(f"launches: {stage}: " + ", ".join(
            f"{n} {now[n] - prev[n]}" for n in kernels))
        prev = now
    require(all(calls[f] == 0 for f in calls),
            f"CudaEngine serving ran a twin: {calls}")
    print(f"serve: {len(s)} queries, batch {srv.batch_size}, second pass "
          f"{1e6 * wall / len(s):.3f} us/query, {len(s) / wall:.1f} qps "
          f"(wall {wall:.4f} s)")
    for k, st in sorted(srv.stats.per_bucket.items()):
        print(f"  bucket {k}: width {st.width}, batches {st.batches}, "
              f"queries {st.queries}, occupancy {st.occupancy:.3f}")
    return dict(d_first=d_first, d=d, dp=dp, paths=paths,
                launches=launches)


def within_qerr(a, b, qerr: float) -> bool:
    """Equal reachability, and where finite |a - b| <= 2·qerr plus the
    argmin threshold's 64 float32 ulps of |b| (the quantized path's
    distance bound against the f32 path, DESIGN.md §11)."""
    fin = np.isfinite(b)
    if not np.array_equal(fin, np.isfinite(a)):
        return False
    slack = 2 * qerr + 64 * np.finfo(np.float32).eps * np.abs(b[fin])
    return bool(np.all(np.abs(a[fin] - b[fin]) <= slack))


def oracle_rows(index, qs) -> np.ndarray:
    """The float64 host oracle on the first ORACLE queries of ``qs``."""
    from repro_torch.core.query import query as host_query

    return np.array([host_query(index, si, ti, want_path=False)[0]
                     for si, ti in zip(qs.s[:ORACLE], qs.t[:ORACLE])])


def near_oracle(d, truth, qerr: float = 0.0) -> float:
    """``d`` against oracle rows ``truth`` (its first len(truth) entries):
    equal reachability and |d - truth| <= 1e-4·max(1, truth) + 2·qerr.
    Returns the max relative error."""
    d = d[:len(truth)]
    require(np.array_equal(np.isfinite(d), np.isfinite(truth)),
            "reachability differs from the float64 oracle")
    fin = np.isfinite(truth)
    err = np.abs(d[fin] - truth[fin])
    rel = float(np.max(err / np.maximum(1.0, truth[fin]), initial=0.0))
    require(bool(np.all(err <= 1e-4 * np.maximum(1.0, truth[fin])
                        + 2 * qerr)),
            f"distance vs float64 oracle: max rel err {rel} "
            f"(2·qerr {2 * qerr})")
    return rel


def oracle_check(d, index, qs, qerr: float = 0.0) -> float:
    """``d`` against the float64 host oracle on the first ORACLE queries
    (:func:`near_oracle`)."""
    return near_oracle(d, oracle_rows(index, qs), qerr)


def check_answers(srv, twin_srv, run: dict, s, t, index, qs,
                  qerr: float = 0.0):
    """The served answers against the twin engine on the card (all five
    argmin outputs, bit for bit), the float64 host oracle (1e-4, equal
    reachability) and the unwound path lengths.  On a quantized artifact
    (``qerr`` > 0) the served distances are the quantized ones and the
    argmin ones are exact where the rescue ran, so those two, the oracle
    and the path lengths are held within 2·qerr instead.  Returns the
    argmin outputs."""
    from repro_torch.core import path_length

    d, dp, paths = run["d"], run["dp"], run["paths"]
    require(np.array_equal(d, run["d_first"]), "two passes disagree")
    require(np.array_equal(d, twin_srv.query(s, t)),
            "CudaEngine d != TorchEngine d")
    # the served argmin path (what query_paths unwinds), all queries
    got = srv._dispatch(s, t, want_argmin=True)
    want = twin_srv._dispatch(s, t, want_argmin=True)
    for name, a, b in zip(ANSWERS, got, want):
        require(np.array_equal(a, b),
                f"CudaEngine vs TorchEngine argmin output {name}")
    if qerr:
        require(within_qerr(got[0], d, qerr), "argmin d vs served d")
        require(within_qerr(dp, d[:PATHS], qerr), "query_paths d vs query d")
    else:
        require(np.array_equal(got[0], d), "argmin d != served d")
        require(np.array_equal(dp, d[:PATHS]), "query_paths d != query d")
    oracle_err = oracle_check(d, index, qs, qerr)
    path_err = max((abs(path_length(p) - x) / max(1.0, x)
                    for p, x in zip(paths, dp) if np.isfinite(x)),
                   default=0.0)
    require(path_err <= 1e-4 + 2 * qerr,
            f"max |path_length - d| / max(1, d) = {path_err}")
    print(f"check: CudaEngine == TorchEngine on all 5 outputs ({len(s)} "
          f"queries); vs float64 oracle on {ORACLE}: reachability equal, "
          f"max rel err {oracle_err:.3e}; paths: max |len - d| / max(1, d) "
          f"{path_err:.3e}; reachable {int(np.isfinite(d).sum())}/{len(d)}"
          + (f"; 2·qerr {2 * qerr:.6e}" if qerr else ""))
    return got


def spread_and_profile(srv, s, t) -> None:
    """Five more passes (us/query min / median / max), then one pass under
    the profiler: wall, device kernel time, idle share, top device ops."""
    import torch

    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        reps.append(1e6 * (time.perf_counter() - t0) / len(s))
    print(f"spread: 5 more passes, us/query min {min(reps):.3f} median "
          f"{float(np.median(reps)):.3f} max {max(reps):.3f}")
    with profiler() as prof:
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    kern = device_times(prof)
    busy = sum(us for _, us in kern.values()) / 1e3
    print(f"profile: one {len(s)}-query pass under the profiler: wall "
          f"{1e3 * wall_p:.3f} ms, device kernels {busy:.3f} ms, idle share "
          f"{1 - busy / (1e3 * wall_p):.4f}")
    for name, (count, us) in sorted(kern.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:9.4f} ms  {count:5d}x  {name[:90]}")


def quantized_path(index, bx, dense_got, s, t, qs, kernels, twins, dev,
                   by_path: dict) -> None:
    """The rooms-M index packed bf16/u16 (DESIGN.md §11), driven through
    ``CudaEngine`` as the other paths are, and its f16 twin checked once."""
    from repro_torch.core.packed import (bucketed_device_bytes,
                                         pack_bucketed, slab_layout)
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    lay = slab_layout("bf16")
    qbx = pack_bucketed(index, layout=lay, device=dev)
    est = bucketed_device_bytes(index, layout=lay)
    print(f"bytes: {MAP} bf16/u16 artifact {qbx.device_bytes()} device "
          f"bytes, f32 artifact {bx.device_bytes()} "
          f"({bx.device_bytes() / qbx.device_bytes():.4f}x smaller); "
          f"bucketed_device_bytes {est}")
    require(est == qbx.device_bytes(),
            "bucketed_device_bytes != the bf16 artifact's device_bytes()")
    st = qbx.quant_stats()
    print(f"quant: layout {st['layout'].dist}/{st['layout'].ids}, qerr "
          f"{st['qerr']:.9g}, id fallback {st['id_fallback']}, via-id "
          f"fallback {st['vid_fallback']}, distance fallback "
          f"{st['dist_fallback']}")
    qerr = st["qerr"]
    print(f"path: {MAP} bf16/u16 quantized")
    eng = CudaEngine(qbx)
    srv = PathServer(eng, batch_size=BATCH)
    run = drive(srv, s, t, index, kernels, twins, f"{MAP} bf16")
    by_path[f"{MAP} bf16"] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0
            and run["launches"]["segvis_tiles"] == 0,
            f"rooms-M bf16 path launches: {run['launches']}")
    # (a) CudaEngine == TorchEngine, (d) the float64 oracle; the rescue
    # share of one full argmin pass
    eng.rescue_batches = eng.rescue_rows = 0
    eng.rescue_seconds = 0.0
    batches = srv.stats.batches
    got = check_answers(srv, PathServer(TorchEngine(qbx), batch_size=BATCH),
                        run, s, t, index, qs, qerr=qerr)
    batches = srv.stats.batches - batches
    print(f"rescue: one argmin pass of {len(s)} queries: {eng.rescue_batches}"
          f" of {batches} batches rescued, {eng.rescue_rows} of "
          f"{batches * BATCH} rows (padding included), host "
          f"{1e3 * eng.rescue_seconds:.3f} ms")
    # (b) distances within 2·qerr of the f32 path, (c) winners bit for bit
    dense_d = dense_got[0]
    diff = np.abs(run["d"] - dense_d)[np.isfinite(dense_d)]
    require(within_qerr(run["d"], dense_d, qerr),
            "bf16 distances beyond 2·qerr of the f32 CudaEngine")
    require(within_qerr(got[0], dense_d, qerr),
            "bf16 argmin distances beyond 2·qerr of the f32 CudaEngine")
    for name, a, b in zip(ANSWERS[1:], got[1:], dense_got[1:]):
        require(np.array_equal(a, b),
                f"bf16 vs f32 CudaEngine argmin winner {name}")
    print(f"check: {MAP} bf16 vs f32 CudaEngine: max |d - d_f32| "
          f"{float(diff.max(initial=0.0)):.6e} (2·qerr {2 * qerr:.6e}); "
          f"covis, via_s, hub, via_t equal bit for bit ({len(s)} queries)")
    spread_and_profile(srv, s, t)

    # the f16 layout, answers only
    fbx = pack_bucketed(index, layout=slab_layout("f16"), device=dev)
    fq = float(fbx.qerr)
    fgot = PathServer(CudaEngine(fbx), batch_size=BATCH)._dispatch(
        s, t, want_argmin=True)
    ftwin = PathServer(TorchEngine(fbx), batch_size=BATCH)._dispatch(
        s, t, want_argmin=True)
    for name, a, b in zip(ANSWERS, fgot, ftwin):
        require(np.array_equal(a, b), f"f16 CudaEngine vs TorchEngine {name}")
    require(within_qerr(fgot[0], dense_d, fq),
            "f16 distances beyond 2·qerr of the f32 CudaEngine")
    for name, a, b in zip(ANSWERS[1:], fgot[1:], dense_got[1:]):
        require(np.array_equal(a, b),
                f"f16 vs f32 CudaEngine argmin winner {name}")
    print(f"check: {MAP} f16/u16 ({fbx.device_bytes()} device bytes, qerr "
          f"{fq:.9g}, fallbacks {fbx.quant_stats()['dist_fallback']}): "
          f"CudaEngine == TorchEngine on all 5 outputs, distances within "
          f"2·qerr of f32, winners equal f32 ({len(s)} queries)")


def budgeted_artifact(scene, graph, bx, s, t, qs, dev) -> None:
    """A fresh rooms-M build merged until its bf16 artifact fits 0.6x the
    f32 artifact's device bytes, packed and served through CudaEngine."""
    from repro_torch.core import build_ehl, compress_to_device_budget
    from repro_torch.core.packed import (bucketed_device_bytes,
                                         pack_bucketed, slab_layout)
    from repro_torch.serving import CudaEngine, PathServer

    lay = slab_layout("bf16")
    target = int(0.6 * bx.device_bytes())
    t0 = time.perf_counter()
    fresh = build_ehl(scene, cell_size=CELL, graph=graph)
    t1 = time.perf_counter()
    st = compress_to_device_budget(fresh, target, layout=lay)
    t2 = time.perf_counter()
    bbx = pack_bucketed(fresh, layout=lay, device=dev)
    est = bucketed_device_bytes(fresh, layout=lay)
    print(f"budget: {MAP} fresh build ({len(fresh.mapper)} cells) merged "
          f"under the bf16 layout to {target} device bytes (0.6x the f32 "
          f"artifact's {bx.device_bytes()}): {st.regions} regions admitted "
          f"(f32 artifact at budget {BUDGET}: {bx.region_bucket.shape[0]}), "
          f"{st.merges} merges, realized {bbx.device_bytes()} device bytes, "
          f"estimator {est}, widths {bbx.widths}; host seconds: build "
          f"{t1 - t0:.3f}, compress_to_device_budget {t2 - t1:.3f}")
    require(st.device_bytes == est == bbx.device_bytes() <= target,
            "budgeted artifact: realized, estimated and stated bytes differ "
            "or exceed the budget")
    srv = PathServer(CudaEngine(bbx), batch_size=BATCH)
    srv.warmup(paths=True)
    d = srv.query(s, t)
    err = oracle_check(d, fresh, qs, float(bbx.qerr))
    print(f"check: budgeted bf16 artifact through CudaEngine: vs float64 "
          f"oracle on {ORACLE}: reachability equal, max rel err {err:.3e} "
          f"(2·qerr {2 * float(bbx.qerr):.6e}); reachable "
          f"{int(np.isfinite(d).sum())}/{len(d)}")


def cell3_check(dev) -> None:
    """``check: cell 3.0``: rooms-S seed 1 at budget 0.2 and cell 3.0 (not
    a power of two), with queries whose one endpoint lies on a cell boundary
    line (x = 3k at y = 30, y = 3k at x = 30) or one float32 ulp below it
    and whose other is a free point of the narrowest bucket, both ways
    round.  The card's ``locate_regions`` must equal the host routing
    (``DeviceEngine._route``) and ``ResidualTable.locate`` on every
    endpoint, for the bucketed layout and the single slab, and every query
    the float64 oracle reaches must be served within 1e-4 of it."""
    import torch

    from repro_torch.core import (build_ehl, build_visgraph,
                                  compress_to_fraction, make_map,
                                  pack_bucketed, pack_index, uniform_queries)
    from repro_torch.core.packed import locate_regions, slab_layout
    from repro_torch.core.query import query as host_query
    from repro_torch.serving import CudaEngine, PathServer

    cell = 3.0
    scene = make_map(GRID_MAP, seed=1)
    graph = build_visgraph(scene)
    idx = build_ehl(scene, cell_size=cell, graph=graph)
    compress_to_fraction(idx, BUDGET)
    bx = pack_bucketed(idx, device=dev)
    eng = CudaEngine(bx)
    lines = np.float32(cell * np.arange(1, idx.nx))
    vals = np.concatenate([lines, np.nextafter(lines, np.float32(-np.inf))])
    mid = np.full_like(vals, 30.0)
    edge = np.concatenate([np.stack([vals, mid], 1),
                           np.stack([mid, vals], 1)]).astype(np.float32)
    free = uniform_queries(scene, graph, 400, seed=7).t.astype(np.float32)
    free = free[eng._route(free) == 0][:len(edge)]
    require(len(free) == len(edge), "too few free points in bucket 0")
    s, t = np.concatenate([edge, free]), np.concatenate([free, edge])
    pts = np.concatenate([s, t])
    on_card = torch.from_numpy(pts).to(dev)
    got = locate_regions(bx, on_card).cpu().numpy()
    resid = pack_bucketed(idx, layout=slab_layout("bf16"),
                          device="cpu").residual
    require(np.array_equal(got, resid.locate(pts)),
            "cell 3.0: card regions != ResidualTable.locate at "
            f"{pts[got != resid.locate(pts)].tolist()}")
    require(np.array_equal(bx.region_bucket.cpu().numpy()[got],
                           eng._route(pts)),
            "cell 3.0: card buckets != DeviceEngine._route")
    rows = locate_regions(pack_index(idx, device=dev), on_card).cpu().numpy()
    slab_resid = pack_index(idx, layout=slab_layout("bf16"),
                            device="cpu").residual
    require(np.array_equal(rows, slab_resid.locate(pts)),
            "cell 3.0: card slab rows != the slab ResidualTable.locate")
    d = PathServer(eng, batch_size=32).query(s, t)
    truth = np.array([host_query(idx, a, b, want_path=False)[0]
                      for a, b in zip(s, t)])
    fin = np.isfinite(truth)
    err = np.abs(d[fin] - truth[fin])
    require(bool(np.all(err <= 1e-4)),
            f"cell 3.0: served distance vs oracle, max err {err.max()}")
    k = int(np.nonzero((s == np.float32([26.999998, 30.0])).all(1))[0][0])
    print(f"check: cell 3.0: {len(pts)} endpoints (on and one ulp below "
          f"every cell boundary, and free points) located on the card as "
          f"DeviceEngine._route and ResidualTable.locate locate them "
          f"(bucketed and slab); {int(fin.sum())} reachable queries within "
          f"1e-4 of the float64 oracle (max err {float(err.max()):.3e}); "
          f"s = (26.999998, 30): served {float(d[k]):.4f}, oracle "
          f"{truth[k]:.4f}")


def slab_path(index, bx, dense_got, s, t, qs, kernels, twins, dev,
              by_path: dict) -> None:
    """The rooms-M index packed into one slab (``pack_index``, every batch
    at the global width), driven as the other paths are; its answers must
    equal the slab TorchEngine's and the bucketed path's bit for bit.  Then
    the bf16/u16 slab's answers (distances within 2·qerr of the f32 slab,
    winners equal to it after the rescue)."""
    from repro_torch.core.packed import (pack_index, slab_device_bytes,
                                         slab_layout)
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine

    pk = pack_index(index, device=dev)
    est = slab_device_bytes(index)
    used, total = pk.label_slots()
    print(f"bytes: {MAP} slab f32 artifact {pk.device_bytes()} device bytes "
          f"(width {pk.label_width}, {pk.num_regions} rows, {used} of "
          f"{total} label slots used), slab_device_bytes {est}; bucketed "
          f"artifact {bx.device_bytes()} "
          f"({pk.device_bytes() / bx.device_bytes():.4f}x it)")
    require(est == pk.device_bytes(),
            "slab_device_bytes != the slab artifact's device_bytes()")
    print(f"path: {MAP} slab f32")
    srv = PathServer(CudaEngine(pk), batch_size=BATCH)
    run = drive(srv, s, t, index, kernels, twins, f"{MAP} slab")
    by_path[f"{MAP} slab"] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0
            and run["launches"]["segvis_tiles"] == 0,
            f"slab path launches: {run['launches']}")
    got = check_answers(srv, PathServer(TorchEngine(pk), batch_size=BATCH),
                        run, s, t, index, qs)
    for name, a, b in zip(ANSWERS, got, dense_got):
        require(np.array_equal(a, b),
                f"slab vs bucketed CudaEngine output {name}")
    print(f"check: {MAP} slab CudaEngine == bucketed CudaEngine on all 5 "
          f"outputs ({len(s)} queries)")
    spread_and_profile(srv, s, t)

    qpk = pack_index(index, layout=slab_layout("bf16"), device=dev)
    qerr = float(qpk.qerr)
    eng = CudaEngine(qpk)
    qgot = PathServer(eng, batch_size=BATCH)._dispatch(s, t,
                                                       want_argmin=True)
    require(within_qerr(qgot[0], got[0], qerr),
            "bf16 slab distances beyond 2·qerr of the f32 slab")
    for name, a, b in zip(ANSWERS[1:], qgot[1:], got[1:]):
        require(np.array_equal(a, b), f"bf16 slab vs f32 slab winner {name}")
    fin = np.isfinite(got[0])
    print(f"check: {MAP} slab bf16/u16 ({qpk.device_bytes()} device bytes, "
          f"qerr {qerr:.9g}): max |d - d_f32| "
          f"{float(np.abs(qgot[0][fin] - got[0][fin]).max(initial=0.0)):.6e}"
          f" (2·qerr {2 * qerr:.6e}); covis, via_s, hub, via_t equal the f32 "
          f"slab's bit for bit; rescue: {eng.rescue_batches} batches, "
          f"{eng.rescue_rows} rows (padding included), host "
          f"{1e3 * eng.rescue_seconds:.3f} ms")


def serve_async(srv, s, t, chunks, argmin: bool = False):
    """Submit ``chunks`` of (s, t) to the batcher, flush and drain; returns
    the answers (distances, or the 5 argmin outputs) in submit order and
    the wall seconds through ``drain``."""
    t0 = time.perf_counter()
    tickets = [srv.submit(s[a:b], t[a:b], want_argmin=argmin)
               for a, b in chunks]
    srv.flush()
    require(srv.drain(timeout=120), "async drain timed out")
    wall = time.perf_counter() - t0
    outs = [tk.result(timeout=1) for tk in tickets]
    cols = [np.concatenate(c) for c in zip(*outs)] if argmin \
        else [np.concatenate(outs)]
    return cols, wall


def async_path(bx, dense_got, s, t, kernels, twins, by_path: dict) -> None:
    """The dense path through the continuous batcher: the same queries
    submitted as one-query trickles and as bursts, flushed and drained.
    Answers must equal the synchronous path's bit for bit (distances and
    argmin); prints the flush mix, the pipeline and queue peaks, us/query
    through ``drain`` beside a synchronous pass of the same run, and one
    profiled burst pass."""
    import torch

    from repro_torch.serving import CudaEngine, PathServer

    print(f"path: {MAP} dense async")
    srv = PathServer(CudaEngine(bx), batch_size=BATCH)
    for k in kernels.values():
        k.launches = 0
    for f in twins:
        f.calls = 0
    srv.warmup(paths=True)
    after_warmup = {n: k.launches for n, k in kernels.items()}
    warm = cold_state()
    n = len(s)
    trickle = [(i, i + 1) for i in range(n)]
    burst = [(i, min(n, i + ASYNC_BURST)) for i in range(0, n, ASYNC_BURST)]

    def serve(chunks, argmin=False):
        return serve_async(srv, s, t, chunks, argmin)

    walls = {}
    for name, chunks in (("trickle", trickle), ("burst", burst)):
        (d,), walls[name] = serve(chunks)
        require(np.array_equal(d, dense_got[0]),
                f"async {name} distances != the synchronous path's")
    got, walls["burst argmin"] = serve(burst, argmin=True)
    for name, a, b in zip(ANSWERS, got, dense_got):
        require(np.array_equal(a, b), f"async argmin output {name} != sync")
    launches = {n_: k.launches - after_warmup[n_]
                for n_, k in kernels.items()}
    by_path[f"{MAP} async"] = {n_: k.launches for n_, k in kernels.items()}
    require(launches["segvis"] > 0 and launches["label_join_rowmin"] > 0,
            f"async path launches: {launches}")
    require(all(f.calls == 0 for f in twins), "the async path ran a twin")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.query(s, t)
    torch.cuda.synchronize()
    walls["sync"] = time.perf_counter() - t0
    report_warmup(f"{MAP} async", warm)
    st = srv.stats
    print(f"launches: async passes: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    print(f"async: {st.submitted} submitted; flushes full "
          f"{st.full_flushes}, deadline {st.deadline_flushes}, forced "
          f"{st.forced_flushes}; pipeline_peak {st.pipeline_peak}, "
          f"queue_depth_peak {st.queue_depth_peak}")
    print("serve: async through drain, us/query: " + ", ".join(
        f"{k} {1e6 * w / n:.3f}" for k, w in walls.items())
        + f" ({n} queries; trickle = {n} one-query submits, burst = "
        f"{len(burst)} submits of {ASYNC_BURST}; sync = one PathServer.query"
        f" pass of the same run)")
    print(f"check: async == sync on all 5 outputs ({n} queries, trickle and "
          f"burst distances, burst argmin)")
    with profiler() as prof:
        _, wall_p = serve(burst)
        torch.cuda.synchronize()
    srv.stop_async()
    kern = device_times(prof)
    busy = sum(us for _, us in kern.values()) / 1e3
    print(f"profile: one burst pass under the profiler: wall "
          f"{1e3 * wall_p:.3f} ms, device kernels {busy:.3f} ms, idle share "
          f"{1 - busy / (1e3 * wall_p):.4f}")
    for name, (count, us) in sorted(kern.items(),
                                    key=lambda kv: -kv[1][1])[:8]:
        print(f"  {us / 1e3:9.4f} ms  {count:5d}x  {name[:90]}")


def artifact_tensors(art) -> list:
    """The device tensors of a packed artifact that a repack does not
    alias (everything but the edge tensors and the edge grid)."""
    import dataclasses

    import torch

    out = []
    for f in dataclasses.fields(art):
        if f.name in ("edges_a", "edges_b", "edges_c", "grid"):
            continue
        v = getattr(art, f.name)
        out += [x for x in (v if isinstance(v, tuple) else (v,))
                if isinstance(x, torch.Tensor)]
    return out


def unaliased_bytes(art) -> int:
    """``device_bytes()`` less the aliased edge tensors and grid."""
    edges = sum(x.numel() * x.element_size()
                for x in (art.edges_a, art.edges_b, art.edges_c))
    return art.device_bytes() - edges - (art.grid.device_bytes()
                                         if art.grid else 0)


def allocated_bytes(tensors) -> int:
    """What the caching allocator holds for ``tensors``: each storage once,
    rounded up to the allocator's block granularity."""
    seen = {}
    for x in tensors:
        st = x.untyped_storage()
        seen[st.data_ptr()] = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
    return sum(seen.values())


def adaptive_path(scene, graph, index, kernels, twins, dev,
                  by_path: dict) -> None:
    """The adaptive index lifecycle on the card (DESIGN.md §8): the
    uncompressed rooms-M index behind an ``IndexManager`` on the CUDA
    kernels, served ``ADAPT_ROUNDS`` rounds of Cluster-2 traffic whose
    distribution shifts at the midpoint.  Each round serves its 2000
    queries, then asks the manager to adapt; round ``ADAPT_LOAD_ROUND``
    instead builds its swap on the manager's thread while the continuous
    batcher serves bursts.  Checks, across every swap: probe answers bit
    for bit (the manager's ``validate_tol=0``), device bytes within the
    budget, edge tensors aliased, nothing cold on the next live traffic,
    the retired artifact's memory freed; then the final generation against
    its twin engine, the float64 oracle and the batcher."""
    import gc
    import weakref

    import torch

    from repro_torch.core import (build_ehl, bucketed_device_bytes,
                                  cluster_queries)
    from repro_torch.indexing import IndexManager
    from repro_torch.serving import (PathServer, TorchEngine,
                                     expected_join_cost)

    label = f"{MAP} adaptive"
    print(f"path: {label}")
    t0 = time.perf_counter()
    fresh = build_ehl(scene, cell_size=CELL, graph=graph, hl=index.hl)
    built = time.perf_counter() - t0
    full = bucketed_device_bytes(fresh)
    budget = int(full * ADAPT_BUDGET)
    phases = [cluster_queries(scene, graph, 2, QUERIES, seed=sd,
                              require_path=False) for sd in ADAPT_SEEDS]
    pts = [(q.s.astype(np.float32), q.t.astype(np.float32)) for q in phases]
    truth = [oracle_rows(index, q) for q in phases]
    for k in kernels.values():
        k.launches = 0
    for f in twins:
        f.calls = 0
    t0 = time.perf_counter()
    mgr = IndexManager(fresh, budget, backend="cuda", device=dev,
                       batch_size=BATCH, min_queries=500,
                       replan_threshold=0.10, min_dwell=1, probe_n=64,
                       seed=17, validate_tol=0.0)
    fit = time.perf_counter() - t0
    print(f"adaptive: {MAP} uncompressed build_ehl {built:.3f} s (graph and "
          f"hub labels of the main path); budget {budget} device bytes "
          f"({ADAPT_BUDGET}x bucketed_device_bytes of the uncompressed "
          f"index, {full}); initial fit "
          f"{mgr.device_bytes()} device bytes, "
          f"{len(mgr.host_index.regions)} regions, widths "
          f"{mgr.engine.artifact.widths}, manager set-up {fit:.3f} s")
    require(mgr.device_bytes() <= budget, "initial fit over the budget")
    # the uniform-score generation's join cost on the shifted workload,
    # taken before any swap: nothing keeps generation 0 alive past its swap
    jc_uni = expected_join_cost(mgr.engine.current, *pts[1])
    srv = PathServer(mgr.engine, batch_size=BATCH, recorder=mgr.recorder)
    srv.warmup()
    probe_gen = mgr.probe_answers()     # ragged probe shapes: not traffic
    warm, warm_gen = cold_state(), 0

    def swap_checks(rnd, prev, m0, probe_pre):
        """A published swap: probe answers bit for bit, bytes within the
        budget, edges aliased, the retired artifact's memory freed."""
        art = mgr.engine.artifact
        probe_post = mgr.probe_answers()
        require(np.array_equal(probe_pre, probe_post, equal_nan=True),
                f"round {rnd}: probe answers changed across the swap")
        require(mgr.device_bytes() <= budget,
                f"round {rnd}: {mgr.device_bytes()} device bytes over the "
                f"budget {budget}")
        require(all(getattr(art, k).data_ptr() == prev["ptrs"][k]
                    for k in prev["ptrs"]),
                f"round {rnd}: the swapped-in edge tensors are not aliased")
        gc.collect()
        m1 = torch.cuda.memory_allocated(dev)
        fall = m0 + allocated_bytes(artifact_tensors(art)) - m1
        require(prev["ref"]() is None,
                f"round {rnd}: the retired artifact is still referenced")
        require(fall >= prev["bytes"],
                f"round {rnd}: memory_allocated fell {fall} bytes, less "
                f"than the retired artifact's {prev['bytes']} unaliased")
        return probe_post, fall

    def live_artifact():
        art = mgr.engine.artifact
        return dict(ptrs={k: getattr(art, k).data_ptr()
                          for k in ("edges_a", "edges_b", "edges_c")},
                    bytes=unaliased_bytes(art),
                    ref=weakref.ref(art.hub_ids[0]))

    def swap_line(rec, fall, retired):
        stages = mgr.telemetry.spans.traces("build")[-1].stages
        return (f"  SWAP[{rec.kind}] drift {rec.drift:.6f}, regions "
                f"{rec.regions}, merges {rec.merges}, host seconds: build "
                f"{rec.build_s:.4f}, repack {stages['repack']:.4f}, "
                f"validate {rec.validate_s:.4f}, stage "
                f"{stages['stage']:.4f}, swap {stages['swap']:.6f}; probe "
                f"max err {rec.probe_max_err}; retired artifact freed "
                f"({fall} bytes fell, {retired} unaliased)")

    def after_live(rnd):
        """The ``warmup:`` line of the first live traffic a generation
        met (taken before any build of this round starts)."""
        nonlocal warm_gen
        if mgr.generation > warm_gen or rnd == 0:
            report_warmup(f"{label} round {rnd} (generation "
                          f"{mgr.generation})", warm)
            warm_gen = mgr.generation

    swaps_seen = 0
    for rnd in range(ADAPT_ROUNDS):
        phase = 0 if rnd < ADAPT_ROUNDS // 2 else 1
        s, t = pts[phase]
        gen0 = mgr.generation
        if rnd == ADAPT_LOAD_ROUND:
            prev, m0, us, probe_pre = load_round(
                srv, mgr, s, t, truth[phase], live_artifact,
                lambda: after_live(rnd), dev)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.query(s, t)
            torch.cuda.synchronize()
            us = 1e6 * (time.perf_counter() - t0) / len(s)
            after_live(rnd)
            probe_pre = mgr.probe_answers()
            require(np.array_equal(probe_pre, probe_gen, equal_nan=True),
                    f"round {rnd}: probe answers moved within a generation")
            prev = live_artifact()
            gc.collect()
            m0 = torch.cuda.memory_allocated(dev)
            mgr.maybe_adapt()
        line = (f"round {rnd} phase {phase}"
                + (" (swap built under batcher load)"
                   if rnd == ADAPT_LOAD_ROUND else "")
                + f": {us:.3f} us/query, device bytes "
                f"{mgr.device_bytes()}, generation {mgr.generation}")
        if mgr.generation > gen0:
            require(mgr.generation == gen0 + 1, "two swaps in one round")
            swaps_seen += 1
            probe_gen, fall = swap_checks(rnd, prev, m0, probe_pre)
            line += "\n" + swap_line(mgr.history[-1], fall, prev["bytes"])
            warm = cold_state()
        print(line)
        del prev
    require(mgr.swaps >= 2 and swaps_seen == mgr.swaps,
            f"adaptive: {mgr.swaps} swaps (need >= 2)")
    require(mgr.validation_failures == 0,
            f"adaptive: {mgr.validation_failures} validation failures")

    # the final generation: batcher == sync, then nothing cold since the
    # last swap, then the launches of the path
    s, t = pts[1]
    want = srv.query(s, t)
    tickets = [srv.submit(s[i:i + ASYNC_BURST], t[i:i + ASYNC_BURST])
               for i in range(0, len(s), ASYNC_BURST)]
    srv.flush()
    require(srv.drain(timeout=120), "adaptive: async drain timed out")
    srv.stop_async()
    got = np.concatenate([tk.result(timeout=1) for tk in tickets])
    require(np.array_equal(got, want),
            "adaptive: async answers on the final generation != sync")
    report_warmup(f"{label} final generation {mgr.generation}", warm)
    launches = {n: k.launches for n, k in kernels.items()}
    calls = {f.__name__: f.calls for f in twins}
    by_path[label] = launches
    print("launches: adaptive path: " + ", ".join(
        f"{n} {v}" for n, v in launches.items()))
    require(launches["segvis"] > 0 and launches["label_join_rowmin"] > 0
            and launches["segvis_tiles"] == 0,
            f"adaptive path launches: {launches}")
    require(all(v == 0 for v in calls.values()),
            f"the adaptive path ran a twin: {calls}")
    print(f"check: adaptive final generation: batcher == sync bit for bit "
          f"({len(s)} queries, {len(tickets)} bursts of {ASYNC_BURST})")

    # the final generation against its twin engine and the oracle
    final = mgr.engine.current
    cgot = PathServer(final, batch_size=BATCH)._dispatch(s, t, True)
    tgot = PathServer(TorchEngine(mgr.engine.artifact),
                      batch_size=BATCH)._dispatch(s, t, True)
    for name, a, b in zip(ANSWERS, cgot, tgot):
        require(np.array_equal(a, b),
                f"adaptive final CudaEngine vs TorchEngine output {name}")
    require(np.array_equal(cgot[0], want), "adaptive argmin d != served d")
    err = near_oracle(want, truth[1])
    jc_adapt = expected_join_cost(final, s, t)
    print(f"check: adaptive final generation {mgr.generation}: CudaEngine =="
          f" TorchEngine on all 5 outputs ({len(s)} queries); vs float64 "
          f"oracle on {ORACLE}: reachability equal, max rel err {err:.3e}")
    print(f"join cost: shifted workload, mean dispatch width^2: adapted "
          f"{jc_adapt:.1f} vs uniform-score generation 0 {jc_uni:.1f} "
          f"(expected_join_cost)")
    st = mgr.stats()
    print(f"lifecycle: {st}; serve: generation {srv.stats.generation}, "
          f"swaps seen {srv.stats.swaps}, stale_batches "
          f"{srv.stats.stale_batches}, requeued_batches "
          f"{srv.stats.requeued_batches}")
    require(st["retired_pending"] == 0 and st["drops"] == st["swaps"],
            f"adaptive: retired generations not all dropped: {st}")
    spread_and_profile(srv, s, t)


def load_round(srv, mgr, s, t, truth, live_artifact, after_live, dev):
    """The shift round under load: half the round's queries go through the
    continuous batcher in bursts of ASYNC_BURST and are drained (recorded),
    then ``maybe_adapt(block=False)`` builds on the manager's thread while
    the batcher takes full passes of the round's queries in bursts, pass
    after pass, until the build ends.  Every ticket must complete and
    answer within 1e-4 of the float64 oracle; the swap must be published.
    Returns (the live artifact before the swap, memory allocated then,
    the round's us/query through the batcher, the probe answers before the
    swap)."""
    import gc

    import torch

    n = len(s)
    bursts = [(i, min(n, i + ASYNC_BURST)) for i in range(0, n, ASYNC_BURST)]
    half = len(bursts) // 2
    t0 = time.perf_counter()
    first = [srv.submit(s[a:b], t[a:b]) for a, b in bursts[:half]]
    srv.flush()
    require(srv.drain(timeout=120), "load round: drain timed out")
    after_live()
    probe_pre = mgr.probe_answers()
    prev = live_artifact()
    gc.collect()
    m0 = torch.cuda.memory_allocated(dev)
    gen0, stale0, requeued0 = (mgr.generation, srv.stats.stale_batches,
                               srv.stats.requeued_batches)
    mgr.maybe_adapt(block=False)
    require(mgr.building, "load round: the manager started no build")
    tickets = []
    while True:
        tickets.append([srv.submit(s[a:b], t[a:b]) for a, b in bursts])
        if not mgr.building or len(tickets) >= 200:
            break
    mgr.join(timeout=300)
    require(not mgr.building, "load round: the build did not finish")
    srv.flush()
    require(srv.drain(timeout=120), "load round: drain timed out")
    wall = time.perf_counter() - t0
    queries = half * ASYNC_BURST
    done = [tk.result(timeout=1) for tk in first]
    err = near_oracle(np.concatenate(done), truth[:half * ASYNC_BURST])
    for group in tickets:
        d = np.concatenate([tk.result(timeout=1) for tk in group])
        err = max(err, near_oracle(d, truth))
        queries += len(d)
    require(mgr.generation == gen0 + 1,
            "load round: the swap built under load was not published")
    print(f"load: {queries} queries in {len(tickets)} batcher passes while "
          f"the swap built ({sum(len(g) for g in tickets) + len(first)} "
          f"tickets, all complete, max rel err vs float64 oracle "
          f"{err:.3e}); "
          f"requeued_batches {srv.stats.requeued_batches - requeued0}, "
          f"stale_batches {srv.stats.stale_batches - stale0}")
    srv.stop_async()
    return prev, m0, 1e6 * wall / queries, probe_pre


def shard_bytes_estimate(index, sh, edge_grid=None) -> list:
    """Each shard's device bytes from the plan, without reading a device
    tensor: the plan's predicted slab bytes, the full-grid mapper, the
    region tables, the clipped edge tensors, the vertex table of a
    quantized layout and the grid its clip would attach."""
    from repro_torch.core.edgegrid import ell_bytes
    from repro_torch.core.packed import (_grid_plan, _pack_edges,
                                         dtype_bytes)

    lb = dtype_bytes(sh.shards[0].layout)
    out = []
    for k, mask in enumerate(sh.edge_masks):
        ea, eb, _ = _pack_edges(index, 128, mask=mask)
        plan = _grid_plan(ea, eb, int(mask.sum()), index.scene, edge_grid)
        grid = 0 if plan is None else ell_bytes(plan[0], plan[1], plan[3])
        regions = int((sh.plan.assignment == k).sum())
        out.append(int(sh.plan.slab_bytes[k]) + index.mapper.size * 4
                   + 2 * regions * 4 + 3 * ea.shape[0] * 2 * 4
                   + index.graph.num_nodes * lb.per_vertex + grid)
    return out


def describe_shards(label: str, sh) -> None:
    """One line per shard: device, regions, widths, bytes, clip, grid."""
    for k, (bx, b) in enumerate(zip(sh.shards, sh.per_shard_bytes())):
        m = sh.edge_masks[k]
        g = bx.grid
        print(f"shard: {label} {k}: device {bx.device}, {bx.num_regions} "
              f"regions, widths {bx.widths}, {b} device bytes, edges kept "
              f"{int(m.sum())} of {len(m)} (E = {bx.num_edges}), "
              + ("dense" if g is None else
                 f"edge grid {g.gnx}x{g.gny}, S = {g.tile_slots}"))


def sharded_operands(sh, gsh, s, t, B: int) -> dict:
    """The sharded path's own kernel operands, at its widest join width:
    the first B queries of the busiest cross-shard routing key there (zero-
    padded to B, as PathServer pads), staged as the router stages them.
    ``fold``: the s side's fold segments against its home shard's clipped
    edges (N = B*W); ``covis``: the batch's s->t segments against the last
    covis participant's clipped edges (N = B); ``join``: the masked label
    rows of both sides on the home shard; ``tiles``: the first TILE_CHUNK
    fold segments of the same group on the ``edge_grid=True`` shards, as
    six [N, S] planes of the home shard's clipped grid (and their dense
    operands)."""
    import torch

    from repro_torch.core.edgegrid import gather_edge_tiles
    from repro_torch.core.packed import _gather_bucketed, _width_bucket
    from repro_torch.serving.shard_router import ShardRouter

    router = ShardRouter(sh)
    keys = router.route_keys(s, t)
    W = int(router.width_classes[-1])
    cand = [k for k in np.unique(keys) if router.key_width(k) == W]
    cross = [k for k in cand if router.decode_key(k)[0]
             != router.decode_key(k)[1]] or cand
    key = max(cross, key=lambda k: int((keys == k).sum()))
    sel = np.nonzero(keys == key)[0][:B]
    sb = np.zeros((B, 2), np.float32)
    tb = np.zeros((B, 2), np.float32)
    sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
    out = {"key": router.decode_key(key)}
    for name, art in (("dense", sh), ("grid", gsh)):
        r = router if art is sh else ShardRouter(art)
        st = r.stage(sb, tb, key)
        bx = art.shards[st.i]
        labels = _gather_bucketed(bx, st.loc_s, _width_bucket(bx, W), W)
        p = torch.repeat_interleave(st.s_dev, W, dim=0)
        q = labels[1].reshape(-1, 2).contiguous()
        edges = (bx.edges_a, bx.edges_b, bx.edges_c)
        if art is sh:
            k = st.parts[-1]
            dev = router.devices[k]
            out["fold"] = (p, q, *edges)
            out["fold_kept"] = int(sh.edge_masks[st.i].sum())
            out["covis"] = (st.s_on[dev], st.t_on[dev], sh.shards[k].edges_a,
                            sh.shards[k].edges_b, sh.shards[k].edges_c)
            out["covis_shard"] = k
            r.fold(st)
            out["join"] = (st.masked_s[0].contiguous(),
                           st.masked_s[1].contiguous(),
                           st.masked_t[0].contiguous(),
                           st.masked_t[1].contiguous())
        else:
            p, q = p[:TILE_CHUNK], q[:TILE_CHUNK]
            out["tiles"] = (p, q, *gather_edge_tiles(bx.grid, *edges, p, q))
            out["tiles_dense"] = (p, q, *edges)
    return out


def routing_line(label: str, eng, s, t) -> None:
    """Host arithmetic on the routing of one pass (as PathServer cuts it):
    routing keys used, batches and slot occupancy, the cross-shard share
    and the covis participants per batch."""
    router = eng.router
    keys = eng.buckets_of(s, t)
    parts, batches = [], 0
    for k in np.unique(keys):
        idx = np.nonzero(keys == k)[0]
        for lo in range(0, len(idx), BATCH):
            sel = idx[lo:lo + BATCH]
            parts.append(len(router.covis_shards(s[sel], t[sel])
                             or [router.decode_key(k)[0]]))
            batches += 1
    pairs = np.array([router.decode_key(k)[:2] for k in keys])
    cross = float(np.mean(pairs[:, 0] != pairs[:, 1]))
    hist = np.bincount(parts, minlength=SHARDS + 1)[1:]
    print(f"routing: {label}: {len(s)} queries on {len(np.unique(keys))} of "
          f"{eng.num_buckets} routing keys, {batches} batches of {BATCH} a "
          f"pass, slot occupancy {len(s) / (batches * BATCH):.4f}; "
          f"cross-shard share {cross:.4f}; covis participants per batch "
          f"min {min(parts)} mean {float(np.mean(parts)):.3f} max "
          f"{max(parts)} (batches with 1..{SHARDS}: {hist.tolist()})")


def sharded_path(index, bx, sh, gsh, dense_got, s, t, qs, kernels, twins,
                 dev, by_path: dict) -> None:
    """The main path's index over SHARDS region shards on the card
    (``ShardPlanner(4).build``), served by a ``ShardedQueryEngine`` on the
    CUDA kernels behind ``PathServer(batch_size=256)``: per-shard lines,
    device bytes (the reference's sizing and the per-shard estimate),
    imbalance, the served answers against the single-device dense path and
    the sharded twin engine bit for bit and the float64 oracle, the
    routing line, the batcher (trickles, bursts) against sync, spread and
    profile.  Then answers-only: the bf16/u16 shards and the
    ``edge_grid=True`` shards."""
    import torch

    from repro_torch import obs
    from repro_torch.core.packed import slab_layout
    from repro_torch.serving import PathServer
    from repro_torch.sharding import ShardedQueryEngine, ShardPlanner

    label = f"{MAP} sharded"
    describe_shards(label, sh)
    per = sh.per_shard_bytes()
    est = shard_bytes_estimate(index, sh)
    print(f"bytes: {label}: {sh.device_bytes()} device bytes over {SHARDS} "
          f"shards {per} (ShardedIndex.device_bytes(); per-shard estimate "
          f"{est}), {sh.device_bytes() / bx.device_bytes():.4f}x the "
          f"unsharded artifact's {bx.device_bytes()}; imbalance "
          f"{sh.imbalance():.4f} after {sh.plan.moves} rebalance moves; "
          f"regions {[b.num_regions for b in sh.shards]}")
    require(sum(per) == sh.device_bytes() and tuple(per) == SHARD_BYTES
            and per == est,
            f"sharded bytes {per} != the reference's {SHARD_BYTES} or the "
            f"estimate {est}")
    require(sh.imbalance() <= SHARD_TOL, f"imbalance {sh.imbalance()}")

    print(f"path: {label}")
    eng = ShardedQueryEngine(sh, backend="cuda")
    srv = PathServer(eng, batch_size=BATCH)
    run = drive(srv, s, t, index, kernels, twins, label)
    by_path[label] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0
            and run["launches"]["segvis_tiles"] == 0,
            f"sharded path launches: {run['launches']}")
    twin = PathServer(ShardedQueryEngine(sh, backend="torch"),
                      batch_size=BATCH)
    got = check_answers(srv, twin, run, s, t, index, qs)
    require(np.array_equal(run["d"], dense_got[0]),
            "sharded d != the single-device dense path's")
    for name, a, b in zip(ANSWERS, got, dense_got):
        require(np.array_equal(a, b),
                f"sharded vs single-device dense output {name}")
    print(f"check: {label} (kernels) == the single-device dense CudaEngine "
          f"and == the sharded twin engine on all 5 outputs ({len(s)} "
          f"queries)")
    routing_line(label, eng, s, t)
    print("shard stats: " + "; ".join(
        f"{st.shard}: batches {st.batches}, slots {st.slots}, gathers_out "
        f"{st.gathers_out}, covis_assists {st.covis_assists}, occupancy "
        f"{st.occupancy:.4f}" for st in srv.stats.per_shard))

    # the batcher: one-query trickles, bursts, burst argmin
    n = len(s)
    trickle = [(i, i + 1) for i in range(n)]
    burst = [(i, min(n, i + ASYNC_BURST)) for i in range(0, n, ASYNC_BURST)]
    walls = {}
    for name, chunks in (("trickle", trickle), ("burst", burst)):
        (d,), walls[name] = serve_async(srv, s, t, chunks)
        require(np.array_equal(d, run["d"]),
                f"sharded async {name} distances != sync")
    agot, walls["burst argmin"] = serve_async(srv, s, t, burst, argmin=True)
    for name, a, b in zip(ANSWERS, agot, got):
        require(np.array_equal(a, b), f"sharded async argmin {name} != sync")
    srv.stop_async()
    require(len(srv.stats.per_shard) == SHARDS, "per_shard rows missing")
    print(f"check: {label} async == sync on all 5 outputs (trickle and burst "
          f"distances, burst argmin); us/query through drain: " + ", ".join(
              f"{k} {1e6 * w / n:.3f}" for k, w in walls.items()))
    spread_and_profile(srv, s, t)

    # bf16/u16 shards, answers only
    for k in kernels.values():
        k.launches = 0
    lay = slab_layout("bf16")
    qsh = ShardPlanner(SHARDS, layout=lay).build(index, device=dev)
    describe_shards(f"{label} bf16", qsh)
    qper, qest = qsh.per_shard_bytes(), shard_bytes_estimate(index, qsh)
    require(tuple(qper) == SHARD_BYTES_BF16 and qper == qest,
            f"bf16 shard bytes {qper} != {SHARD_BYTES_BF16} or the "
            f"estimate {qest}")
    qeng = ShardedQueryEngine(qsh, backend="cuda")
    qsrv = PathServer(qeng, batch_size=BATCH)
    qsrv.warmup(paths=True)
    qd = qsrv.query(s, t)
    qgot = qsrv._dispatch(s, t, want_argmin=True)
    qerr = max(float(b.qerr) for b in qsh.shards)
    require(within_qerr(qd, got[0], qerr) and within_qerr(qgot[0], got[0],
                                                          qerr),
            "sharded bf16 distances beyond 2·qerr of the f32 sharded path")
    for name, a, b in zip(ANSWERS[1:], qgot[1:], got[1:]):
        require(np.array_equal(a, b), f"sharded bf16 winner {name} != f32")
    wire = sum(c.value for c in obs.REGISTRY.find(
        "router_wire_rows_total", router=qeng.router._obs_labels["router"],
        wire="quant"))
    require(wire > 0, "the quantized wire shipped no rows")
    by_path[f"{label} bf16"] = {n_: k.launches for n_, k in kernels.items()}
    fin = np.isfinite(got[0])
    print(f"check: {label} bf16/u16 ({qsh.device_bytes()} device bytes, "
          f"{qper} = the reference's and the estimate; qerr {qerr:.9g}): max "
          f"|d - d_f32| {float(np.abs(qd[fin] - got[0][fin]).max()):.6e} "
          f"(2·qerr {2 * qerr:.6e}); covis, via_s, hub, via_t equal the f32 "
          f"sharded path's bit for bit; rescue {qeng.rescue_batches} "
          f"batches, {qeng.rescue_rows} rows; quantized wire rows "
          f"{int(wire)}")

    # edge_grid=True shards: segvis_tiles on the clipped grids
    for k in kernels.values():
        k.launches = 0
    describe_shards(f"{label} grid", gsh)
    gper = gsh.per_shard_bytes()
    require(tuple(gper) == SHARD_BYTES_GRID
            and gper == shard_bytes_estimate(index, gsh, edge_grid=True)
            and all(b.grid is not None for b in gsh.shards),
            f"grid shards {gper} != {SHARD_BYTES_GRID}, or one lacks a grid")
    gsrv = PathServer(ShardedQueryEngine(gsh, backend="cuda"),
                      batch_size=BATCH)
    gsrv.warmup(paths=True)
    require(np.array_equal(gsrv.query(s, t), dense_got[0]),
            "sharded grid d != dense d")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gsrv.query(s, t)
    torch.cuda.synchronize()
    grid_us = 1e6 * (time.perf_counter() - t0) / len(s)
    ggot = gsrv._dispatch(s, t, want_argmin=True)
    for name, a, b in zip(ANSWERS, ggot, dense_got):
        require(np.array_equal(a, b), f"sharded grid vs dense output {name}")
    glaunch = {n_: k.launches for n_, k in kernels.items()}
    by_path[f"{label} grid"] = glaunch
    require(glaunch["segvis_tiles"] > 0 and glaunch["segvis"] == 0,
            f"sharded grid launches: {glaunch}")
    print(f"check: {label} edge_grid=True ({gsh.device_bytes()} device "
          f"bytes, {gper}): == the dense path on all 5 outputs; second pass "
          f"{grid_us:.3f} us/query; launches: "
          + ", ".join(f"{k} {v}" for k, v in glaunch.items()))
    torch.cuda.synchronize()


def shard_tensors(sh) -> dict:
    """{storage pointer: allocator bytes} of every device tensor of a
    sharded artifact (slabs, tables, edges, grids)."""
    import dataclasses

    import torch

    out = {}
    for bx in sh.shards:
        ts = []
        for f in dataclasses.fields(bx):
            v = getattr(bx, f.name)
            ts += [x for x in (v if isinstance(v, tuple) else (v,))
                   if isinstance(x, torch.Tensor)]
        if bx.grid is not None:
            ts += [bx.grid.cell_ids, bx.grid.cell_len]
        for x in ts:
            st = x.untyped_storage()
            out[st.data_ptr()] = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
    return out


def sharded_acceptance(kernels, twins, dev, by_path: dict) -> None:
    """The reference's sharded acceptance configuration on the card:
    rooms-S seed 1 at budget 0.3 over 4 shards, 1000 uniform queries equal
    to the single-device bucketed answers bit for bit; then an
    ``IndexManager(num_shards=4, backend="cuda")`` at 0.5x the bucketed
    artifact plus the sharding overhead, batch 64, whose swap builds on
    its thread while the batcher serves: answers bit-stable throughout, one
    generation published across all four shards, no shard over its cap,
    the retired shards' memory freed."""
    import gc
    import weakref

    import torch

    from repro_torch.core import (build_ehl, build_hub_labels,
                                  build_visgraph, bucketed_device_bytes,
                                  cluster_queries, compress_to_fraction,
                                  make_map, pack_bucketed,
                                  query_batch_bucketed, uniform_queries)
    from repro_torch.indexing import IndexManager
    from repro_torch.serving import PathServer
    from repro_torch.sharding import (ShardedQueryEngine, ShardPlanner,
                                      sharded_overhead_bytes)

    label = f"{GRID_MAP} sharded acceptance"
    for k in kernels.values():
        k.launches = 0
    for f in twins:
        f.calls = 0
    scene = make_map(GRID_MAP, seed=ACCEPT_SEED)
    graph = build_visgraph(scene)
    hl = build_hub_labels(graph)
    idx = build_ehl(scene, CELL, graph=graph, hl=hl)
    compress_to_fraction(idx, ACCEPT_BUDGET)
    bx = pack_bucketed(idx, device=dev)
    sh = ShardPlanner(SHARDS).build(idx, device=dev)
    describe_shards(label, sh)
    require(tuple(sh.per_shard_bytes()) == ACCEPT_BYTES,
            f"acceptance shards {sh.per_shard_bytes()} != {ACCEPT_BYTES}")
    require(max(sh.per_shard_bytes()) <= SHARD_TOL * sh.device_bytes()
            / SHARDS, "acceptance shards over 1.15x their fair share")
    qs = uniform_queries(scene, graph, ACCEPT_QUERIES, seed=42,
                         require_path=False)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    ref = query_batch_bucketed(bx, s, t, use_kernels=True)
    out = ShardedQueryEngine(sh, backend="cuda").query(s, t)
    require(np.array_equal(ref, out), "acceptance: sharded != single-device")

    idx2 = build_ehl(scene, CELL, graph=graph, hl=hl)
    budget = int(bucketed_device_bytes(idx2) * 0.5) \
        + sharded_overhead_bytes(idx2, SHARDS)
    mgr = IndexManager(idx2, budget, backend="cuda", device=dev,
                       batch_size=ACCEPT_BATCH, min_queries=60,
                       replan_threshold=0.10, min_dwell=0, probe_n=32,
                       num_shards=SHARDS, seed=13, validate_tol=0.0)
    cap = SHARD_TOL * budget / SHARDS
    require(max(mgr.engine.per_shard_bytes()) <= cap,
            "acceptance: generation 0 has a shard over its cap")
    srv = PathServer(mgr.engine, batch_size=ACCEPT_BATCH,
                     recorder=mgr.recorder)
    srv.warmup()
    cq = cluster_queries(scene, graph, 2, 200, seed=31, require_path=False)
    cs, ct = cq.s.astype(np.float32), cq.t.astype(np.float32)
    d0 = srv.query(cs, ct)
    old = mgr.engine.artifact
    old_ptrs, old_ref = shard_tensors(old), weakref.ref(old.shards[0].mapper)
    old_shards = [id(b) for b in old.shards]
    del old
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    mgr.maybe_adapt(block=False)
    require(mgr.building, "acceptance: the manager started no build")
    passes = 0
    chunks = [(i, min(len(cs), i + 25)) for i in range(0, len(cs), 25)]
    while True:
        (d,), _ = serve_async(srv, cs, ct, chunks)
        require(np.array_equal(d, d0),
                "acceptance: answers moved while the swap built")
        passes += 1
        if not mgr.building:
            break
    mgr.join(timeout=300)
    srv.stop_async()
    d1 = srv.query(cs, ct)
    require(np.array_equal(d1, d0), "acceptance: answers moved across swap")
    new = mgr.engine.artifact
    require(mgr.generation == 1 and mgr.validation_failures == 0
            and srv.stats.generation == 1,
            f"acceptance: generation {mgr.generation}, failures "
            f"{mgr.validation_failures}, served {srv.stats.generation}")
    require(not any(id(b) in old_shards for b in new.shards),
            "acceptance: the new generation reuses an old shard object")
    per = mgr.engine.per_shard_bytes()
    require(max(per) <= cap, f"acceptance: shard bytes {per} over the cap "
            f"{cap:.0f}")
    new_ptrs = shard_tensors(new)
    aliased = old_ptrs.keys() & new_ptrs.keys()
    want = sum(v for p, v in old_ptrs.items() if p not in aliased)
    gc.collect()
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated(dev)
    fall = m0 + sum(v for p, v in new_ptrs.items() if p not in aliased) - m1
    require(old_ref() is None, "acceptance: the retired shards are alive")
    require(fall >= want, f"acceptance: memory fell {fall} bytes, less than "
            f"the retired shards' {want} unaliased")
    launches = {n_: k.launches for n_, k in kernels.items()}
    by_path[label] = launches
    require(launches["label_join_rowmin"] > 0
            and all(f.calls == 0 for f in twins),
            f"acceptance launches {launches}, twin calls")
    st = mgr.stats()
    rec = mgr.history[-1]
    stages = mgr.telemetry.spans.traces("build")[-1].stages
    print(f"SWAP[{rec.kind}] {label}: drift {rec.drift:.6f}, regions "
          f"{rec.regions}, host seconds: build {rec.build_s:.4f}, repack "
          f"{stages['repack']:.4f}, validate {rec.validate_s:.4f}, stage "
          f"{stages['stage']:.4f}, swap {stages['swap']:.6f}")
    print(f"check: {label}: {ACCEPT_QUERIES} uniform queries == the "
          f"single-device bucketed answers bit for bit; manager budget "
          f"{budget} (0.5x bucketed + overhead), generation 0 shards "
          f"within the cap {cap:.0f}; swap built on the manager's thread "
          f"over {passes} batcher passes of {len(cs)} Cluster-2 queries, "
          f"answers bit-stable throughout and after; generation "
          f"{mgr.generation} on all {SHARDS} new shards {per}, "
          f"{len(aliased)} tensors aliased; retired shards freed ({fall} "
          f"bytes fell, {want} unaliased); stats {st}; launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (build_ehl, build_visgraph,
                                  compress_to_fraction, make_map,
                                  pack_bucketed, uniform_queries)
    from repro_torch.core.edgegrid import gather_edge_tiles
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.label_join import label_join_rowmin
    from repro_torch.kernels.segvis import _launch as segvis_launch
    from repro_torch.kernels.segvis import block_threads, launch_shape, segvis
    from repro_torch.kernels.segvis_tiles import segvis_tiles
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine
    from repro_torch.sharding import ShardPlanner

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    twins = (ref.segvis_ref, ref.segvis_tiles_ref, ref.label_join_rowmin_ref)

    # -- 1. card and build -------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.3f} s ({', '.join(build.KERNEL_SOURCES)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2. host indexes: the main path's map and the grid path's map --------
    def host_index(name, seed):
        t0 = time.perf_counter()
        scene = make_map(name, seed=seed)
        graph = build_visgraph(scene)
        index = build_ehl(scene, cell_size=CELL, graph=graph)
        t1 = time.perf_counter()
        compress_to_fraction(index, BUDGET)
        return scene, graph, index, t1 - t0, time.perf_counter() - t1

    def describe(name, bx, built, packed):
        g = bx.grid
        grid = ("dense" if g is None else
                f"edge grid {g.gnx}x{g.gny}, M = {g.ell_width}, "
                f"S = {g.tile_slots}")
        print(f"index: {name} build {built:.2f} s, compress {packed:.2f} s; "
              f"{bx.region_bucket.shape[0]} regions, widths {bx.widths}, "
              f"E = {bx.num_edges}, {grid}, {bx.device_bytes()} device bytes")

    scene, graph, index, built, packed = host_index(MAP, MAP_SEED)
    bx = pack_bucketed(index, device=dev)
    describe(f"{MAP} (default policy)", bx, built, packed)
    require(bx.grid is None, "the auto policy attached a grid on rooms-M")
    gbx = pack_bucketed(index, edge_grid=True, device=dev)
    describe(f"{MAP} (edge_grid=True)", gbx, built, packed)
    require((gbx.grid.gnx, gbx.grid.gny, gbx.grid.ell_width,
             gbx.grid.tile_slots) == (16, 16, 4, 192),
            "rooms-M forced grid is not 16x16, M = 4, S = 192")
    sscene, sgraph, sindex, built, packed = host_index(GRID_MAP, GRID_SEED)
    sbx = pack_bucketed(sindex, device=dev)
    describe(f"{GRID_MAP} seed {GRID_SEED} (default policy)", sbx, built,
             packed)
    require(sbx.grid is not None and (sbx.grid.gnx, sbx.grid.gny,
                                      sbx.grid.ell_width,
                                      sbx.grid.tile_slots) == (8, 8, 4, 96),
            "the auto policy did not attach the 8x8, M = 4, S = 96 grid on "
            "rooms-S seed 0")
    t0 = time.perf_counter()
    sh = ShardPlanner(SHARDS).build(index, device=dev)
    gsh = ShardPlanner(SHARDS).build(index, edge_grid=True, device=dev)
    print(f"index: {MAP} over {SHARDS} region shards on {sh.devices}: "
          f"planned and packed twice (edge_grid auto and True) in "
          f"{time.perf_counter() - t0:.3f} s")
    B = BATCH
    E = bx.num_edges

    # -- 3. kernels against their twins at their paths' shapes ----------------
    rng = np.random.default_rng(0)
    verts = np.asarray(graph.nodes)
    seg_shapes = [B] + [B * w for w in bx.widths]
    seg_args = {n: segvis_inputs(rng, bx, n, verts, dev) for n in seg_shapes}
    seg_err = 0.0
    for n, args in seg_args.items():
        got, want = segvis(*args), ref.segvis_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"segvis != twin at N={n}, E={E}")
        seg_err = max(seg_err, max_abs_err(got, want))
    for args in segvis_case_table(rng, dev):
        got, want = segvis(*args), ref.segvis_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"segvis != twin on case N={args[0].shape[0]}, "
                f"E={args[2].shape[0]}")
    print(f"check: segvis == twin at N in {seg_shapes}, E = {E}, and on "
          f"4 random contact cases")
    join_args = {L: rowmin_inputs(rng, B, L, dev) for L in bx.widths}
    join_err = 0.0
    for L, args in join_args.items():
        got, want = label_join_rowmin(*args), ref.label_join_rowmin_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"rowmin != twin at B={B}, L={L}")
        join_err = max(join_err, max_abs_err(got, want))
    print(f"check: label_join_rowmin == twin at B = {B}, L in {bx.widths}")
    # the main path's own operands: its fold segments and masked label rows
    qs = uniform_queries(scene, graph, QUERIES, seed=QUERY_SEED)
    s, t = qs.s.astype(np.float32), qs.t.astype(np.float32)
    main_ops = main_path_operands(bx, CudaEngine(bx), s, t, B)
    for w, (fold_s, fold_t, covis, join) in main_ops.items():
        for what, args in (("fold s", fold_s), ("fold t", fold_t),
                           ("covis", covis)):
            got, want = segvis(*args), ref.segvis_ref(*args)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"segvis != twin on the main path's {what} at W={w}")
            seg_err = max(seg_err, max_abs_err(got, want))
        got, want = label_join_rowmin(*join), ref.label_join_rowmin_ref(*join)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"rowmin != twin on the main path's rows at W={w}")
        join_err = max(join_err, max_abs_err(got, want))
    print(f"check: segvis (fold s, fold t, covis) and label_join_rowmin == "
          f"twins on the main path's own operands at W in "
          f"{sorted(main_ops)} (first {B} served queries per bucket)")
    # bf16/f16 distances, both sides one type: the kernel widens at staging
    narrow = {"bf16": torch.bfloat16, "f16": torch.float16}
    narrow_rows = {}
    for L in bx.widths:
        for what, (hs, vs, ht, vt) in (("synthetic", join_args[L]),
                                       ("main-path", main_ops[L][3])):
            for name, dt in narrow.items():
                args = (hs, vs.to(dt), ht, vt.to(dt))
                got = label_join_rowmin(*args)
                want = ref.label_join_rowmin_ref(*args)
                torch.cuda.synchronize()
                require(got.dtype == torch.float32 and torch.equal(got, want),
                        f"rowmin != twin at {name} distances, {what} B={B}, "
                        f"L={L}")
                if what == "main-path":
                    narrow_rows[(name, L)] = args
    print(f"check: label_join_rowmin == twin with bf16 and f16 distances "
          f"(float32 out) at B = {B}, L in {bx.widths}, synthetic and "
          f"main-path rows")
    tile_args, tile_dense = {}, {}
    tile_err = 0.0
    for gb, vs in ((sbx, np.asarray(sgraph.nodes)), (gbx, verts)):
        S = gb.grid.tile_slots
        for n in (B, TILE_CHUNK):
            args, dense = tile_inputs(rng, gb, n, vs, dev)
            got, want = segvis_tiles(*args), ref.segvis_tiles_ref(*args)
            torch.cuda.synchronize()
            require(torch.equal(got, want),
                    f"segvis_tiles != twin at N={n}, S={S}")
            require(torch.equal(got, ref.segvis_ref(*dense)),
                    f"segvis_tiles != dense segvis twin at N={n}, S={S}")
            tile_err = max(tile_err, max_abs_err(got, want))
            tile_args[(S, n)], tile_dense[(S, n)] = args, dense
    cases = tile_case_table(rng, dev)
    for args in cases:
        got, want = segvis_tiles(*args), ref.segvis_tiles_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"segvis_tiles != twin on case N={args[0].shape[0]}, "
                f"S={args[2].shape[1]}")
    print(f"check: segvis_tiles == twin (and == dense segvis twin) at "
          f"(S, N) in {sorted(tile_args)}; segvis_tiles == twin on "
          f"{len(cases)} contact cases, (N, S) in "
          f"{[tuple(a[2].shape) for a in cases]}")
    # the sharded path's own operands: a clipped fold, a covis batch on a
    # participant's clip, a home-shard join, a clipped-grid tile chunk
    shard_ops = sharded_operands(sh, gsh, s, t, B)
    for what, args in (("fold", shard_ops["fold"]),
                       ("covis", shard_ops["covis"])):
        got, want = segvis(*args), ref.segvis_ref(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"segvis != twin on the sharded path's {what}")
        seg_err = max(seg_err, max_abs_err(got, want))
    got = label_join_rowmin(*shard_ops["join"])
    want = ref.label_join_rowmin_ref(*shard_ops["join"])
    torch.cuda.synchronize()
    require(torch.equal(got, want), "rowmin != twin on the sharded join")
    join_err = max(join_err, max_abs_err(got, want))
    got = segvis_tiles(*shard_ops["tiles"])
    want = ref.segvis_tiles_ref(*shard_ops["tiles"])
    torch.cuda.synchronize()
    require(torch.equal(got, want)
            and torch.equal(got, ref.segvis_ref(*shard_ops["tiles_dense"])),
            "segvis_tiles != twins on the sharded clipped-grid chunk")
    tile_err = max(tile_err, max_abs_err(got, want))
    i, j, w = shard_ops["key"]
    print(f"check: segvis (fold N={shard_ops['fold'][0].shape[0]} on shard "
          f"{i}'s clipped edges, {shard_ops['fold_kept']} kept, padded to "
          f"{shard_ops['fold'][2].shape[0]}; covis "
          f"N={B} on shard {shard_ops['covis_shard']}'s clip), "
          f"label_join_rowmin (B={B}, L={w}, home shard {i}, t side from "
          f"shard {j}) and segvis_tiles (N={TILE_CHUNK}, S="
          f"{shard_ops['tiles'][2].shape[1]} on shard {i}'s clipped grid) "
          f"== twins on the sharded path's own operands")

    # -- 3b. point location at a cell size that is not a power of two --------
    cell3_check(dev)

    # -- 4. dense main path: CudaEngine behind PathServer ----------------------
    kernels = {"segvis": segvis, "label_join_rowmin": label_join_rowmin,
               "segvis_tiles": segvis_tiles}
    by_path = {}
    print(f"path: {MAP} dense (default policy)")
    srv = PathServer(CudaEngine(bx), batch_size=B)
    run = drive(srv, s, t, index, kernels, twins, f"{MAP} dense")
    by_path[f"{MAP} dense"] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0,
            f"a kernel of the dense path never launched: {run['launches']}")
    require(run["launches"]["segvis_tiles"] == 0,
            "the dense path launched segvis_tiles")

    # -- 5. answers: twins on the card, float64 oracle, path lengths ----------
    dense_got = check_answers(srv, PathServer(TorchEngine(bx), batch_size=B),
                              run, s, t, index, qs)

    # -- 6. where the serving time goes (device kernels vs wall) -------------
    spread_and_profile(srv, s, t)

    # -- 6b. the single slab, f32 path and bf16 answers -----------------------
    slab_path(index, bx, dense_got, s, t, qs, kernels, twins, dev, by_path)

    # -- 6c. the dense path through the continuous batcher --------------------
    async_path(bx, dense_got, s, t, kernels, twins, by_path)

    # -- 7. edge-grid path at the default policy (rooms-S seed 0) -------------
    sqs = uniform_queries(sscene, sgraph, QUERIES, seed=QUERY_SEED)
    ss, st = sqs.s.astype(np.float32), sqs.t.astype(np.float32)
    print(f"path: {GRID_MAP} seed {GRID_SEED} edge grid (default policy)")
    ssrv = PathServer(CudaEngine(sbx), batch_size=B)
    run = drive(ssrv, ss, st, sindex, kernels, twins, f"{GRID_MAP} grid")
    by_path[f"{GRID_MAP} grid"] = run["launches"]
    require(run["launches"]["segvis_tiles"] > 0
            and run["launches"]["label_join_rowmin"] > 0,
            f"a kernel of the grid path never launched: {run['launches']}")
    require(run["launches"]["segvis"] == 0,
            "the grid path launched dense segvis")
    check_answers(ssrv, PathServer(TorchEngine(sbx), batch_size=B), run,
                  ss, st, sindex, sqs)
    spread_and_profile(ssrv, ss, st)

    # -- 8. edge-grid path at the main path's full width (rooms-M, forced) ----
    print(f"path: {MAP} edge grid (edge_grid=True)")
    gsrv = PathServer(CudaEngine(gbx), batch_size=B)
    run = drive(gsrv, s, t, index, kernels, twins, f"{MAP} grid")
    by_path[f"{MAP} grid"] = run["launches"]
    require(run["launches"]["segvis_tiles"] > 0
            and run["launches"]["segvis"] == 0,
            f"rooms-M grid path launches: {run['launches']}")
    got = gsrv._dispatch(s, t, want_argmin=True)
    for name, a, b in zip(ANSWERS, got, dense_got):
        require(np.array_equal(a, b),
                f"rooms-M grid vs dense CudaEngine output {name}")
    require(np.array_equal(run["d"], dense_got[0]), "grid d != dense d")
    print(f"check: {MAP} grid CudaEngine == dense CudaEngine on all 5 "
          f"outputs ({len(s)} queries)")
    spread_and_profile(gsrv, s, t)

    # -- 9. quantized path: rooms-M bf16/u16, then f16 answers ---------------
    quantized_path(index, bx, dense_got, s, t, qs, kernels, twins, dev,
                   by_path)

    # -- 10. a device-budgeted bf16 artifact ----------------------------------
    budgeted_artifact(scene, graph, bx, s, t, qs, dev)

    # -- 10b. the adaptive index lifecycle: capture, replan, hot swap ---------
    adaptive_path(scene, graph, index, kernels, twins, dev, by_path)

    # -- 10c. region sharding: four shards on the card, then the reference's
    # sharded acceptance configuration with a swap under load -------------
    sharded_path(index, bx, sh, gsh, dense_got, s, t, qs, kernels, twins,
                 dev, by_path)
    sharded_acceptance(kernels, twins, dev, by_path)

    # -- 11. kernel times beside the twins' and the bound ---------------------
    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return 1e3 * max(tb, to), ("bytes" if tb > to else "operations")

    def times(kernel_fn, twin_fn, kernel_name):
        """(kernel device ms, its wrapper's stream ms, twin device ms).  The
        kernel's time is its mean duration over the launches the profiler
        saw in 50 calls; a session that saw none (the profiler drops a
        session's device events now and then) is run again, twice at most."""
        for _ in range(3):
            seen = [(c, us) for name, (c, us) in device_ms(kernel_fn, 50)
                    .items() if kernel_name in name]
            if seen:
                break
        require(seen, f"the profiler saw no {kernel_name}")
        ms = sum(us for _, us in seen) / sum(c for c, _ in seen) / 1e3
        plain = sum(us for _, us in device_ms(twin_fn, 5).values()) / 5 / 1e3
        return ms, cuda_ms(kernel_fn, 50), plain

    def seg_time(what, args):
        """Time segvis on ``args``; bound from the pairs these inputs need
        (up to each segment's first blocking edge), the all-pairs bound and
        the unfused-issue time beside it."""
        n = args[0].shape[0]
        ms, wrap, plain = times(lambda: segvis(*args),
                                lambda: ref.segvis_ref(*args), "segvis_kernel")
        nbytes = 2 * n * 8 + 3 * E * 8 + n      # p, q, edges in; flags out
        need = pairs_needed(args)
        b_ms, by = bound(nbytes, SEGVIS_OPS_PER_PAIR * need)
        all_ms, _ = bound(nbytes, SEGVIS_OPS_PER_PAIR * n * E)
        issue_ms = 1e3 * SEGVIS_OPS_PER_PAIR * need / F32_UNFUSED_ISSUE_PER_S
        g, threads = launch_shape(n)
        print(f"time: segvis {what} N={n} E={E} (G={g}, {threads} threads "
              f"a block): kernel {ms:.5f} ms (wrapper {wrap:.5f} ms), twin "
              f"{plain:.5f} ms, bound {b_ms:.5f} ms ({by}; {need} of "
              f"{n * E} pairs needed, all pairs {all_ms:.5f} ms; at the "
              f"unfused issue rate {issue_ms:.5f} ms)")
        return (n, ms, plain, b_ms, by)

    def join_time(what, args):
        """Time label_join_rowmin on ``args``; bound = the sorted join's
        bytes, the dense join's operations printed beside it."""
        Bj, L = args[0].shape
        ms, wrap, plain = times(lambda: label_join_rowmin(*args),
                                lambda: ref.label_join_rowmin_ref(*args),
                                "label_join_rowmin_kernel")
        nbytes = join_bytes(Bj, L, args[1].element_size())
        b_ms, by = bound(nbytes, 0)
        dense_ms, _ = bound(0, join_dense_ops(Bj, L))
        print(f"time: label_join_rowmin {what} B={Bj} L={L} "
              f"{args[1].dtype}: kernel {ms:.5f} ms (wrapper {wrap:.5f} "
              f"ms), twin {plain:.5f} ms, bound {b_ms:.5f} ms ({by}: "
              f"{nbytes} bytes; the dense join's {join_dense_ops(Bj, L)} "
              f"operations {dense_ms:.5f} ms)")
        return (L, ms, plain, b_ms, by)

    tile_rows = []
    for args in seg_args.values():
        seg_time("synthetic", args)
    for args in join_args.values():
        join_time("synthetic", args)
    main_seg, main_join, narrow_ms = [], [], {}
    for w, (fold_s, fold_t, covis, join) in main_ops.items():
        main_seg.append(seg_time(f"main-path fold s W={w}", fold_s))
        seg_time(f"main-path fold t W={w}", fold_t)
        main_join.append(join_time(f"main-path W={w}", join))
        for name in ("bf16", "f16"):
            narrow_ms[name] = join_time(f"main-path W={w}",
                                        narrow_rows[(name, w)])[1]
    main_seg.insert(0, seg_time(f"main-path covis W={max(main_ops)}",
                                main_ops[max(main_ops)][2]))

    # segvis at every group size G on the main path's operands (CUDA-graph
    # device time, so the host's launch path is not in it): why
    # launch_shape picks the G it does
    for what, args in [("covis", main_ops[max(main_ops)][2])] + [
            (f"fold s W={w}", ops[0]) for w, ops in main_ops.items()]:
        n = args[0].shape[0]
        want = ref.segvis_ref(*args)
        out = torch.empty(n, dtype=torch.bool, device=dev)
        cols = []
        for g in (1, 2, 4, 8, 16, 32):
            th = block_threads(n, g)
            out.fill_(False)
            segvis_launch(*args, out, g, th)
            torch.cuda.synchronize()
            require(torch.equal(out, want),
                    f"segvis at G={g} != twin on the main path's {what}")
            ms = graph_ms(lambda: segvis_launch(*args, out, g, th))
            cols.append(f"G={g}/{th}: {ms:.5f}")
        print(f"time: segvis by group size, main-path {what} N={n} "
              f"(G/threads: graph ms; the wrapper picks G="
              f"{launch_shape(n)[0]}): " + ", ".join(cols))
    for (S, n), args in sorted(tile_args.items()):
        ms, wrap, plain = times(lambda: segvis_tiles(*args),
                                lambda: ref.segvis_tiles_ref(*args),
                                "segvis_tiles_kernel")
        # bytes and operations of the slots the OR must read on these
        # inputs (up to each segment's first blocking slot), p/q in, flags out
        need = slots_needed(args)
        b_ms, by = bound(6 * 4 * need + 2 * n * 8 + n,
                         TILE_OPS_PER_SLOT * need)
        full_ms, _ = bound(6 * 4 * n * S + 2 * n * 8 + n,
                           TILE_OPS_PER_SLOT * n * S)
        tile_rows.append(((S, n), ms, plain, b_ms, by))
        print(f"time: segvis_tiles N={n} S={S}: kernel {ms:.5f} ms (wrapper "
              f"{wrap:.5f} ms), twin {plain:.5f} ms, bound {b_ms:.5f} ms "
              f"({by}; {need} of {n * S} slots needed, all slots "
              f"{full_ms:.5f} ms)")
        grid = (sbx if S == sbx.grid.tile_slots else gbx).grid
        p, q, ea, eb, ec = tile_dense[(S, n)]
        walk = device_ms(lambda: gather_edge_tiles(grid, ea, eb, ec, p, q),
                         20)
        launches = sum(c for c, _ in walk.values()) / 20
        walk_ms = sum(us for _, us in walk.values()) / 20 / 1e3
        print(f"time: walk + gather N={n} S={S}: device {walk_ms:.5f} ms in "
              f"{launches:.0f} device ops per call")

    totals = {n: sum(run[n] for run in by_path.values()) for n in kernels}

    def record(name, source, replaces, rows, err, shape):
        _, ms, plain, b_ms, by = rows[-1]       # the widest path shape
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": totals[name],
                "launches_by_path": {p: run[name]
                                     for p, run in by_path.items()},
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                "shape": shape}

    print(card)                 # as nvidia-smi printed it
    print(json.dumps({"kernels": [
        record("segvis", "src/repro_torch/kernels/csrc/segvis.cu",
               "src/repro/kernels/segvis.py:50", main_seg, seg_err,
               f"main-path fold N={main_seg[-1][0]},E={E}"),
        dict(record("label_join_rowmin",
                    "src/repro_torch/kernels/csrc/label_join.cu",
                    "src/repro/kernels/label_join.py:33", main_join,
                    join_err, f"main-path B={B},L={main_join[-1][0]}"),
             ms_by_dtype={"float32": main_join[-1][1], **narrow_ms}),
        record("segvis_tiles", "src/repro_torch/kernels/csrc/segvis_tiles.cu",
               "src/repro/kernels/segvis.py:124", tile_rows, tile_err,
               "N={1},S={0}".format(*tile_rows[-1][0])),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
