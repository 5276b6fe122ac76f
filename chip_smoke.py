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
then drives nine serving paths, each with the launch counts set to 0 just
before it and read just after, and each with a ``warmup:`` line (nvcc
builds and ctypes loads from the registry's ``kernel_builds_total`` and
``kernel_loads_total``, and cold shape keys, met on live traffic after
``warmup(paths=True)``, all required to be 0, and the allocator's segment
count before and after):

* the dense main path: rooms-M (seed 0, cell 2.0) compressed to 20% of its
  label memory, packed into width buckets on the card (the auto edge-grid
  policy leaves it dense), served by a ``CudaEngine`` behind
  ``PathServer(batch_size=256)`` for 2000 uniform queries (seed 33) plus
  ``query_paths`` on 64 of them (``segvis`` + ``label_join_rowmin``);
* the telemetry path (DESIGN.md §12-§13): the same artifact behind a
  fresh ``PathServer(batch_size=128)`` that samples every request, with
  ``obs.enable_profile(timing=True)`` installed before its warmup: cold
  entries (``entry_cold_total``) and kernel builds and loads in the
  registry at warmup and none on live traffic, answers equal to the same
  server's under ``Telemetry.off()`` and to the batch-256 path's bit for
  bit, every sync and async span tree complete and telescoping within 5%,
  a shed, the Prometheus export round-tripping with ``serve_queries_total``
  and ``bucket_queries_total`` equal to what was served and routed,
  ``entry_stream_ms`` and the kernels' analytic costs of one pass, then
  the overhead of ``Telemetry()`` against ``Telemetry.off()`` and of the
  capture against none (printed, not gated);
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

Then two LM paths (``repro_torch.models``, plain PyTorch: they launch none
of the kernels, and their counts, set to 0 before each, must stay 0):

* tinyllama-1.1b at its published width (22 layers, d_model 2048, 32
  heads, 4 kv heads, d_ff 5632, vocab 32000), random init from a seeded
  generator on the card: in float32 (TF32 off) stepped decode equals
  forward at B=2, S=32 (rtol 2e-3, atol 2e-4, the reference's decode
  test) and the card's forward the CPU's at B=1, S=8 (rtol 1e-4, atol
  1e-4); then the bf16 ``LMServer`` at B = 1, 8 and 32 (a 64-token prompt
  stepped into a 256-slot cache, then ``generate(64)`` three times from
  that cache): ms per decode step (median of 3), tokens/s,
  ``max_memory_allocated``, one profiled step (device ms, device ops,
  idle share), the step's bytes over the HBM rate (``lm_step_bytes``) and
  how often the first token's top-1 equals the f32 model's (printed, not
  gated); tokens in range and ``queries == B·64`` gated;
* the ten architectures' ``reduced()`` configs: forward on the card equals
  the CPU's on the same parameters (rtol 1e-4, atol 1e-5 times the larger
  of 1 and the logits' largest magnitude), and for the six decode
  representatives stepped decode equals forward on the card (rtol 2e-3,
  atol 2e-4).

Then two LM training paths (``models.transformer.loss_fn``, ``optim``,
``launch.train``; plain PyTorch, no EHL kernel launched):

* tinyllama-1.1b trained at its published width from a seeded random
  init: loss and every gradient leaf on the card equal the CPU's at B=1,
  S=16 (f32, TF32 off; rtol 1e-4, atol 1e-4 times each leaf's largest
  |value|; the loss within rtol 1e-5), then 12 steps of
  ``build_train_step`` at B=8, S=512 on ``synthetic_batch`` (f32
  parameters and AdamW moments, remat "full", ce_chunk 512, lr 1e-3,
  warmup 5), the last loss below the first: ms per step (median after the
  first two), tokens/s, ``max_memory_allocated``, one profiled step
  (device ms, device ops, idle share) and the step against 8·N·T FLOP over
  the float32 peak; then the same with bf16 parameters against the bf16
  peak;
* the ten reduced configs: loss and gradients on the card equal the CPU's
  (the CPU parity tests' tolerances), the launcher (``main([...,
  "--device", "cuda"])``) for the nine token-only families, and on
  tinyllama reduced 16 guarded steps with a fault at step 6 and
  checkpoints every 4 under ``build/`` (the guard restores step 4, the
  loss falls), a ``--resume`` run from step 15, and ``--grad-compress`` on
  one rank (the loss falls).

After the sharded paths, a tenth EHL path: data-parallel serving,
``PathServer(CudaEngine(rooms-M dense), mesh=(cuda:0, cuda:0),
batch_sharding="rows")``, each batch of 256 as two row blocks on the one
card's replica, driven like the others (answers == the dense path's bit
for bit, nothing cold, both kernels launched, no twin, ``start_async``
refused).  Then ``syncs:``, the dynamic complement of the port's invariant
pass (``lint:``, run right after the build over this checkout's
``src/repro_torch``: 0 findings required): on each warmed engine of the
EHL paths (rooms-M dense, slab, bf16/u16, the four shards in f32 and
bf16, batch-sharded), one batch's ``stage`` + ``dispatch_staged`` under
``torch.cuda.set_sync_debug_mode("warn")``, each reported sync attributed
to its innermost ``repro_torch.serving``/``.sharding`` frame: none on the
f32 engines, every other one at a ``hot-path-sync`` marker, answers equal
to the synchronous call's; and ``quickstart:``, the quickstart twin on the
card (kernels == twins bit for bit, within 1e-4 of the host query).  Then
the distributed half on one card (plain PyTorch, no EHL
kernel launched; every mesh is one NCCL rank, so multi-rank traffic is
not exercised here: it is held on the CPU over gloo by the tests):

* tinyllama-1.1b trained on a ("data", "model") mesh: DTensor parameters
  from ``param_shardings``, batches from ``global_batch_arrays``; one
  step's loss and gradients beside the one-device step's (f32, TF32 off;
  rtol 1e-4 + atol 1e-4 x each leaf's largest |value|, bit-equality
  printed), then 4 steps in f32 and in bf16 beside the one-device steps of
  the same seed and batches (losses within rtol 1e-5 / 1e-2), ms per step,
  tokens/s, peak bytes, one profiled step each; a bf16 checkpoint saved
  and restored with ``restore(mesh=)``, leaf bits equal;
* ``decode_attention_dist`` at tinyllama's decode width (B=8, Smax=2048,
  H=32, K=4, hd=64, bf16), three (pos, window, softcap) cases, against
  ``decode_attention`` plus the slot write (outputs within rtol 1.6e-2 +
  atol 1e-3, caches bit for bit), times beside;
* ``moe_block_ep`` for one llama4-scout-17b-a16e MoE layer at its
  published width (4278517760 bytes of bf16 weights, 4096 tokens) against
  ``moe_block`` at the same capacity: forward and the weights' gradients,
  two all-to-alls counted, times beside;
* ``pipeline_forward``, one stage over tinyllama's 22 layers (f32, 4
  microbatches) against ``forward_hidden`` (rtol 1e-4 + atol 1e-4 x
  scale);
* the fake-rank dry run (``python -m repro_torch.launch.dryrun``, one
  process a cell, started together): tinyllama-1.1b ``train_4k`` and
  nemotron-4-340b ``decode_32k`` on the 256-rank pod mesh (per-rank
  bytes, peak live bytes, FLOPs per rank, collectives);
* one line saying that no multi-rank NCCL run was possible when the
  machine has fewer than two cards.

Before the adaptive path, the f16 layout is checked once (answers only),
and a fresh rooms-M build is merged to 0.6x the f32 artifact's device
bytes under the bf16 layout (``compress_to_device_budget``) and served.  ``label_join_rowmin``
is also held against its twin with bf16 and f16 distances at every
main-path width, and the ``label_join`` entry (the row join, then
``torch.amin``; on no serving path, as in the reference) against
``label_join_ref`` at float32, bf16 and f16.  The bf16 path's
``rescue_batches_total`` and the sharded path's per-shard
``shard_slots_total`` are read back from the export.  The answers are checked against the twin engine on the
card (bit for bit) and the float64 host oracle (1e-4, plus 2·qerr on a
quantized artifact).  Prints the card, the build time, per-kernel times
beside the twins' and the bound (counted from what each run's inputs
need: ``pairs_needed``, ``join_bytes``, on the shape terms of
``obs.profile.kernel_cost``), the ``segvis`` time at every group
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
sys.path.insert(0, str(ROOT / "src"))

# the shape terms of every bound: the port's cost model of one launch
from repro_torch.obs.profile import (SEGVIS_OPS_PER_PAIR,  # noqa: E402
                                     TILE_BYTES_PER_SLOT, TILE_OPS_PER_SLOT,
                                     kernel_cost)

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.  bound_ms = max(bytes / HBM, ops / F32).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The 67e12 counts an fma as two operations.  The visibility predicate is
# written unfused for bit equality, so one instruction is one operation:
# 132 SMs * 128 float32 lanes * 1.98 GHz boost clock.  Printed beside the
# segvis bound as a note, never used as the bound.
F32_UNFUSED_ISSUE_PER_S = 132 * 128 * 1.98e9
# SEGVIS_OPS_PER_PAIR (34) and TILE_OPS_PER_SLOT (36) come from the cost
# model (``repro_torch.obs.profile``); the bounds below refine its all-pairs
# and all-slots counts to what each run's inputs need.
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
# the telemetry path: a batch size no other path serves at (every shape key
# cold for its server) and its one-query submits
TELEMETRY_BATCH, TELEMETRY_TRICKLES = 128, 256
# the most of a sync trace's end-to-end time its reply (the remainder after
# the stamped stages: scatter and stats) may take
SYNC_REPLY_SHARE = 0.25
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
# the LM paths (repro_torch.models): tinyllama-1.1b at its published width
# (f32 decode == forward at the reference test's tolerance, then card ==
# CPU at B=1, S=8), the bf16 LMServer (a 64-token prompt stepped into a
# 256-slot cache, then 64 greedy tokens, 3 passes at each batch), and the
# ten architectures' reduced configs
LM_ARCH, LM_SEED = "tinyllama-1.1b", 7
LM_MAX_LEN, LM_PROMPT, LM_NEW, LM_PASSES = 256, 64, 64, 3
LM_BATCHES = (1, 8, 32)
LM_DECODE_ARCHS = ("tinyllama-1.1b", "deepseek-v3-671b", "gemma2-27b",
                   "mamba2-780m", "hymba-1.5b", "whisper-large-v3")
# the LM training paths: tinyllama-1.1b at its published width (f32
# parameters and AdamW moments, remat "full", ce_chunk 512) on
# synthetic_batch streams, card == CPU loss and gradients at B=1, S=16,
# then LM_TRAIN_STEPS steps in f32 and in bf16 (warmup 5); the reduced
# families through the launcher
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_LR = 8, 512, 12, 1e-3
# card == CPU gradients at full width: rtol 1e-4 and atol 1e-4 times the
# leaf's largest |value| (gradients sit far below 1, so the LM forward
# checks' floor of 1 on the scale would make the check blind); the loss
# within rtol 1e-5
LM_GRAD_RTOL, LM_GRAD_ATOL = 1e-4, 1e-4
# the reduced families on the card against the CPU: the CPU parity tests'
# rule (rtol 1e-4, atol 1e-5 times the larger of 1 and the leaf's largest
# |value|; mamba2 atol 5e-5, tests/test_torch_lm_grad.py)
LM_FAMILY_ATOL = {"mamba2-780m": 5e-5}
# H100 SXM peaks for the training step's bound (NVIDIA data sheet, dense):
# float32 outside the tensor cores (TF32 is off for the f32 run) and bf16
F32_PEAK_FLOPS, BF16_PEAK_FLOPS = 67e12, 989e12
# device kernel names of the cuBLAS/CUTLASS matmuls (lower case)
GEMM_KERNEL_TAGS = ("gemm", "xmma", "cutlass", "nvjet")
# the distributed half on a one-rank mesh: tinyllama-1.1b trained on a
# ("data", "model") NCCL mesh at B=8, S=512 beside the one-device step of
# the same seed and batches (MESH_STEPS steps, f32 with TF32 off then bf16
# parameters); its losses within MESH_LOSS_RTOL of the one-device step's
# and one step's gradients within LM_GRAD_RTOL plus LM_GRAD_ATOL times each
# leaf's largest |value| (tree_errors), bit-equality reported
MESH_STEPS = 4
MESH_LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-2}
# decode_attention_dist at tinyllama's decode width, bf16, against
# decode_attention plus the slot write: (pos, window, softcap) cases as in
# tests/test_distributed_exec.py; outputs within 2 bf16 ulps (rtol
# 1.6e-2) plus atol 1e-3, the written caches bit for bit
FLASH_SHAPE = dict(B=8, Smax=2048, H=32, K=4, hd=64)
FLASH_CASES = ((1500, 0, 0.0), (700, 256, 30.0), (2047, 0, 50.0))
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-3
# one llama4-scout-17b-a16e MoE layer at its published width (d_model
# 5120, 16 experts, top-1, moe_d_ff 8192, one shared expert) on
# MOE_TOKENS = 8 x 512 tokens, bf16
MOE_ARCH, MOE_SHAPE = "llama4-scout-17b-a16e", (8, 512)
# the pipeline: tinyllama's full stack as one stage, f32 (TF32 off), B=8,
# S=512, 4 microbatches, against forward_hidden (rtol 1e-4 and atol 1e-4
# times the hidden state's largest |value|: other matmul shapes per
# microbatch)
PIPE_MICRO = 4
# the fake-rank dry run's cells (python -m repro_torch.launch.dryrun)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "pod"),
                ("nemotron-4-340b", "decode_32k", "pod"))


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
    output written once (``kernel_cost``)."""
    return kernel_cost("label_join_rowmin", (B, L), dist_bytes)["bytes"]


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
    allocated) so far in this process; the builds and loads as the
    registry's ``kernel_builds_total`` and ``kernel_loads_total``."""
    import torch

    from repro_torch.core.packed import TRACES
    from repro_torch.obs import REGISTRY

    return (TRACES.count, int(REGISTRY.total("kernel_builds_total")),
            int(REGISTRY.total("kernel_loads_total")),
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
                   by_path: dict, staged: dict) -> None:
    """The rooms-M index packed bf16/u16 (DESIGN.md §11), driven through
    ``CudaEngine`` as the other paths are, and its f16 twin checked once."""
    from repro_torch import obs
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
    staged[f"{MAP} bf16"] = eng
    srv = PathServer(eng, batch_size=BATCH)
    run = drive(srv, s, t, index, kernels, twins, f"{MAP} bf16")
    by_path[f"{MAP} bf16"] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0
            and run["launches"]["segvis_tiles"] == 0,
            f"rooms-M bf16 path launches: {run['launches']}")
    # (a) CudaEngine == TorchEngine, (d) the float64 oracle; the rescue
    # share of one full argmin pass
    eng.rescue_rows = 0
    eng.rescue_seconds = 0.0
    batches = srv.stats.batches
    rescued0 = series_of(obs.REGISTRY, "rescue_batches_total", "engine")
    got = check_answers(srv, PathServer(TorchEngine(qbx), batch_size=BATCH),
                        run, s, t, index, qs, qerr=qerr)
    batches = srv.stats.batches - batches
    export_round_trips(obs.REGISTRY)
    rescued = grown(series_of(obs.REGISTRY, "rescue_batches_total",
                              "engine"), rescued0)
    # (the twin engine's rescues land on its own row, engine="torch")
    require(rescued.get("cuda", 0) > 0 and eng.rescue_rows > 0,
            f"rescue_batches_total grew by {rescued}, the CudaEngine "
            f"rescued {eng.rescue_rows} rows")
    print(f"rescue: one argmin pass of {len(s)} queries: {rescued['cuda']:g}"
          f" of {batches} batches rescued (rescue_batches_total"
          f"{{engine=cuda}}), {eng.rescue_rows} of {batches * BATCH} rows "
          f"(padding included), host {1e3 * eng.rescue_seconds:.3f} ms")
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
              by_path: dict, staged: dict) -> None:
    """The rooms-M index packed into one slab (``pack_index``, every batch
    at the global width), driven as the other paths are; its answers must
    equal the slab TorchEngine's and the bucketed path's bit for bit.  Then
    the bf16/u16 slab's answers (distances within 2·qerr of the f32 slab,
    winners equal to it after the rescue)."""
    from repro_torch import obs
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
    staged[f"{MAP} slab"] = srv.engine
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
    rescued0 = series_of(obs.REGISTRY, "rescue_batches_total", "engine")
    qgot = PathServer(eng, batch_size=BATCH)._dispatch(s, t,
                                                       want_argmin=True)
    rescued = grown(series_of(obs.REGISTRY, "rescue_batches_total",
                              "engine"), rescued0).get("cuda", 0)
    require(within_qerr(qgot[0], got[0], qerr),
            "bf16 slab distances beyond 2·qerr of the f32 slab")
    for name, a, b in zip(ANSWERS[1:], qgot[1:], got[1:]):
        require(np.array_equal(a, b), f"bf16 slab vs f32 slab winner {name}")
    fin = np.isfinite(got[0])
    print(f"check: {MAP} slab bf16/u16 ({qpk.device_bytes()} device bytes, "
          f"qerr {qerr:.9g}): max |d - d_f32| "
          f"{float(np.abs(qgot[0][fin] - got[0][fin]).max(initial=0.0)):.6e}"
          f" (2·qerr {2 * qerr:.6e}); covis, via_s, hub, via_t equal the f32 "
          f"slab's bit for bit; rescue: {rescued:g} batches, "
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


def series_of(reg, name: str, key: str) -> dict:
    """{label ``key``: value} of one registry series family."""
    return {dict(m.labels).get(key): m.value for m in reg.series(name)}


def grown(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def complete_traces(traces, stages, what: str) -> int:
    """Every trace closed, carrying every stage of ``stages``, no stage
    negative (stamps out of order), its stages summing to its end-to-end
    time within 5%.  A sync trace's stamped stages (``route``,
    ``dispatch``) are positive and its ``reply``, the remainder after the
    stamps, is at most SYNC_REPLY_SHARE of the whole, so a stage left
    unstamped shows; an answered async trace waited on the device
    (``device_join`` positive).  Returns the count."""
    require(traces, f"no {what} traces recorded")
    for tr in traces:
        require(tr.closed and tr.complete(stages),
                f"a {what} trace lacks a stage: {sorted(tr.stages)}")
        require(min(tr.stages.values()) >= 0.0,
                f"a {what} trace has a negative stage: {tr.stages}")
        require(abs(tr.stage_sum - tr.e2e_seconds)
                <= 0.05 * tr.e2e_seconds,
                f"a {what} trace does not telescope: stages "
                f"{tr.stage_sum} s, e2e {tr.e2e_seconds} s")
        if tr.kind == "sync" and not tr.attrs.get("coarse"):
            require(tr.stages["route"] > 0 and tr.stages["dispatch"] > 0
                    and tr.stages["reply"]
                    <= SYNC_REPLY_SHARE * tr.e2e_seconds,
                    f"a sync trace left a stage unstamped: {tr.stages}, "
                    f"e2e {tr.e2e_seconds} s")
        if tr.kind == "async" and tr.attrs["outcome"] == "ok":
            require(tr.stages["device_join"] > 0,
                    f"an async trace has no device_join: {tr.stages}")
    return len(traces)


def export_round_trips(reg) -> dict:
    """The registry's Prometheus text parsed back: every counter and gauge
    to its value, every histogram to its count.  Returns the parse."""
    from repro_torch import obs

    parsed = obs.parse_prometheus(obs.prometheus_text(reg))
    for m in reg.metrics():
        key = tuple(m.labels)
        if isinstance(m, obs.Histogram):
            require(parsed[m.name + "_count"][key] == m.count,
                    f"export: histogram {m.name} count")
        else:
            require(parsed[m.name][key] == m.value,
                    f"export: series {m.name}{dict(key)} does not round-trip")
    return parsed


def telemetry_path(bx, index, dense_got, s, t, kernels, twins,
                   by_path: dict) -> None:
    """The serving telemetry and attribution on the card (DESIGN.md §12-§13).

    A fresh rooms-M dense server at batch TELEMETRY_BATCH (every shape key
    cold for it) that samples every request, with the profile capture
    timing every entry by CUDA events installed before its warmup: cold
    entries and kernel builds and loads in the registry, none on live
    traffic; answers equal to the same server's under ``Telemetry.off()``
    without the capture, and to the batch-256 dense path's, bit for bit on
    all 5 outputs; sync and async span trees complete and telescoping; a
    shed; the export round-tripping with the serving and bucket series;
    per-entry stream ms and the kernels' analytic costs of one pass.  Then
    the overhead of the default ``Telemetry()`` against ``Telemetry.off()``
    and of the capture against none, printed and not gated."""
    import torch

    from repro_torch import obs
    from repro_torch.core.packed import SERVING_ENTRIES, TRACES
    from repro_torch.kernels import build
    from repro_torch.serving import CudaEngine, PathServer, QueueFull

    label = f"{MAP} telemetry"
    print(f"path: {label}")
    reg = obs.REGISTRY
    for k in kernels.values():
        k.launches = 0
    for f in twins:
        f.calls = 0
    tel = obs.Telemetry(sample_rate=1.0)
    eng = CudaEngine(bx)
    srv = PathServer(eng, batch_size=TELEMETRY_BATCH, telemetry=tel)
    cap = obs.enable_profile(timing=True)
    try:
        count0 = TRACES.count
        cold0 = series_of(reg, "entry_cold_total", "entry")
        srv.warmup(paths=True)
        met = grown(series_of(reg, "entry_cold_total", "entry"), cold0)
        require({"fold_endpoint", "join_endpoints"} <= set(met)
                and sum(met.values()) == TRACES.count - count0,
                f"warmup: entry_cold_total grew by {met}, TRACES.count by "
                f"{TRACES.count - count0}")
        recorded = {e: len(r) for e, r in cap.by_entry().items()}
        require(recorded == {e: n for e, n in met.items()
                             if e in SERVING_ENTRIES},
                f"capture's cold calls {recorded} != entry_cold_total "
                f"growth {met}")
        builds = series_of(reg, "kernel_builds_total", "kernel")
        loads = series_of(reg, "kernel_loads_total", "kernel")
        require(all(builds.get(n, 0) <= 1 and loads.get(n) == 1
                    for n in build.KERNEL_SOURCES),
                f"kernel builds {builds}, loads {loads}: each source is "
                f"built at most and loaded exactly once in a process")
        warm = cold_state()
        cold_warm = series_of(reg, "entry_cold_total", "entry")
        cold_s = series_of(reg, "entry_cold_seconds_total", "entry")
        print(f"attribution: warmup at batch {TELEMETRY_BATCH}: cold calls "
              + ", ".join(f"{e} {n}" + (f" ({cold_s[e]:.4f} s)"
                                         if e in cold_s else "")
                          for e, n in sorted(met.items()))
              + f"; nvcc builds {builds}, loads {loads}")

        # live traffic: sync passes, paths, the argmin dispatch, async
        routed = np.zeros(eng.num_buckets, np.int64)

        def route(a, b):
            routed[:] += np.bincount(eng.buckets_of(a, b),
                                     minlength=eng.num_buckets)

        d = srv.query(s, t)
        route(s, t)
        srv.query_paths(s[:PATHS], t[:PATHS], host_index=index)
        route(s[:PATHS], t[:PATHS])
        got = srv._dispatch(s, t, want_argmin=True)
        route(s, t)
        ops0 = series_of(reg, "kernel_cost_ops_total", "kernel")
        bytes0 = series_of(reg, "kernel_cost_bytes_total", "kernel")
        srv.query(s, t)
        route(s, t)
        pass_ops = grown(series_of(reg, "kernel_cost_ops_total", "kernel"),
                         ops0)
        pass_bytes = grown(series_of(reg, "kernel_cost_bytes_total",
                                     "kernel"), bytes0)
        n = len(s)
        trickle = [(i, i + 1) for i in range(TELEMETRY_TRICKLES)]
        burst = [(i, min(n, i + ASYNC_BURST))
                 for i in range(0, n, ASYNC_BURST)]
        (dt,), _ = serve_async(srv, s, t, trickle)
        route(s[:TELEMETRY_TRICKLES], t[:TELEMETRY_TRICKLES])
        (db,), _ = serve_async(srv, s, t, burst)
        route(s, t)
        srv.stop_async()
        require(np.array_equal(dt, dense_got[0][:TELEMETRY_TRICKLES])
                and np.array_equal(db, dense_got[0]),
                "telemetry async answers != the dense path's")
        # a shed: one submit larger than an empty queue's bound
        srv.start_async(max_queue=1, policy="shed")
        try:
            srv.submit(s[:2], t[:2])
            require(False, "a submit over max_queue was admitted")
        except QueueFull:
            pass
        srv.stop_async()
        report_warmup(label, warm)
        require(series_of(reg, "entry_cold_total", "entry") == cold_warm,
                "live traffic added to entry_cold_total")
        require(all(len(r) == recorded[e]
                     for e, r in cap.by_entry().items()),
                "live traffic credited a cold call")
        summary = cap.summary()
    finally:
        obs.disable_profile()
    launches = {n_: k.launches for n_, k in kernels.items()}
    by_path[label] = launches
    require(launches["segvis"] > 0 and launches["label_join_rowmin"] > 0
            and launches["segvis_tiles"] == 0,
            f"telemetry path launches: {launches}")
    require(all(f.calls == 0 for f in twins), "the telemetry path ran a twin")
    print("launches: telemetry path: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))

    # answers: == Telemetry.off() without the capture, == batch 256
    off = PathServer(CudaEngine(bx), batch_size=TELEMETRY_BATCH,
                     telemetry=obs.Telemetry.off())
    off.warmup(paths=True)
    d_off = off.query(s, t)
    got_off = off._dispatch(s, t, want_argmin=True)
    require(np.array_equal(d, d_off) and np.array_equal(d, dense_got[0]),
            "telemetry-on distances != Telemetry.off() / batch-256 dense")
    for name, a, b, c in zip(ANSWERS, got, got_off, dense_got):
        require(np.array_equal(a, b),
                f"telemetry on vs off (batch {TELEMETRY_BATCH}) {name}")
        require(np.array_equal(a, c),
                f"batch {TELEMETRY_BATCH} vs batch {BATCH} dense {name}")
    print(f"check: {label}: answers with telemetry (sample rate 1.0, "
          f"profile timing) == Telemetry.off() without the capture == the "
          f"batch-{BATCH} dense path, all 5 outputs bit for bit ({n} "
          f"queries at batch {TELEMETRY_BATCH})")

    # spans and events
    n_sync = complete_traces(tel.spans.traces("sync"), obs.SYNC_STAGES,
                             "sync")
    require(all(tr.stages["unwind"] > 0 for tr in tel.spans.traces("sync")
                if tr.attrs.get("argmin") and not tr.attrs.get("coarse")),
            "query_paths trace without unwind time")
    traces = tel.spans.traces("async")
    shed = [tr for tr in traces if tr.attrs["outcome"] == "shed"]
    n_async = complete_traces(traces, obs.ASYNC_STAGES, "async")
    require(len(shed) == 1 and len(tel.events.events("shed")) == 1
            and srv.stats.shed == 2, "shed: one trace, one event, 2 queries")
    print(f"check: {label}: {n_sync} sync traces ({', '.join(obs.SYNC_STAGES)})"
          f" and {n_async} async traces ({len(obs.ASYNC_STAGES)} stages; "
          f"{TELEMETRY_TRICKLES} trickles, {len(burst)} bursts, 1 shed) "
          f"complete, no stage negative, stage sums within 5% of e2e, "
          f"sync reply <= {SYNC_REPLY_SHARE} of e2e, async device_join > 0;"
          f" events "
          f"{tel.events.counts()}")

    # the export
    parsed = export_round_trips(reg)
    srv_lbl = srv.stats.labels["srv"]
    served = [v for k, v in parsed["serve_queries_total"].items()
              if dict(k)["srv"] == srv_lbl]
    want_served = 3 * n + PATHS + TELEMETRY_TRICKLES
    require(served == [srv.stats.queries] == [want_served],
            f"serve_queries_total {served} != {want_served} served")
    rows = {int(dict(k)["bucket"]): v
            for k, v in parsed["bucket_queries_total"].items()
            if dict(k)["srv"] == srv_lbl and dict(k)["gen"] == "0"}
    require(rows == {k: int(c) for k, c in enumerate(routed) if c},
            f"bucket_queries_total {rows} != routed {routed.tolist()}")
    print(f"check: {label}: export round-trips ({len(parsed)} families, "
          f"{len(reg.metrics())} series); serve_queries_total {served[0]} "
          f"= queries served; bucket_queries_total{{gen=0}} {rows} = "
          f"queries routed per bucket")

    # attribution
    print("attribution: entry_stream_ms (stream time between CUDA events, "
          "host gaps included, resolved after the traffic): " + ", ".join(
              f"{e} median {v['stream_ms_median']:.4f} ms x "
              f"{v['stream_calls']}" for e, v in summary.items()
              if v["stream_calls"]))
    print(f"attribution: kernel cost of one {n}-query pass at batch "
          f"{TELEMETRY_BATCH}: " + ", ".join(
              f"{k} {pass_ops[k]:.0f} ops, {pass_bytes[k]:.0f} bytes"
              for k in sorted(pass_ops)))
    require(set(pass_ops) == {"segvis", "label_join_rowmin"},
            f"kernel costs of a dense pass: {pass_ops}")
    telemetry_overhead(bx, s, t)


def telemetry_overhead(bx, s, t) -> None:
    """Interleaved best-of-3: sync passes and bursts of ASYNC_BURST through
    the batcher, the default ``Telemetry()`` against ``Telemetry.off()``,
    then the profile capture (CUDA-event timing) against none.  qps ratios
    and p99 request latency, printed beside the reference's gates."""
    import torch

    from repro_torch import obs
    from repro_torch.serving import CudaEngine, PathServer

    n = len(s)
    servers = {"default": PathServer(CudaEngine(bx), batch_size=BATCH),
               "off": PathServer(CudaEngine(bx), batch_size=BATCH,
                                 telemetry=obs.Telemetry.off())}
    for srv in servers.values():
        srv.warmup()
        srv.start_async()

    def sync_pass(srv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.query(s, t)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def burst_pass(srv):
        t0 = time.perf_counter()
        tickets = [srv.submit(s[i:i + ASYNC_BURST], t[i:i + ASYNC_BURST])
                   for i in range(0, n, ASYNC_BURST)]
        require(srv.drain(timeout=120), "overhead: drain timed out")
        wall = time.perf_counter() - t0
        return wall, [tk.completed_at - tk.t_submit for tk in tickets]

    def measure(configs):
        best = {c: [np.inf, np.inf] for c in configs}
        lat = {c: [] for c in configs}
        for _ in range(3):
            for c, (srv, profile) in configs.items():
                cap = obs.enable_profile(timing=True) if profile else None
                try:
                    w_sync = sync_pass(srv)
                    w_burst, ls = burst_pass(srv)
                finally:
                    if cap is not None:
                        obs.disable_profile()
                        cap.drain()
                best[c] = [min(best[c][0], w_sync), min(best[c][1], w_burst)]
                lat[c] += ls
        return best, {c: 1e3 * float(np.percentile(v, 99))
                      for c, v in lat.items()}

    for what, configs in (
            ("Telemetry() vs Telemetry.off()",
             {"on": (servers["default"], False),
              "off": (servers["off"], False)}),
            ("profile capture (timing) vs none",
             {"on": (servers["default"], True),
              "off": (servers["default"], False)})):
        best, p99 = measure(configs)
        (s_on, b_on), (s_off, b_off) = best["on"], best["off"]
        print(f"overhead: {what}, best of 3 interleaved: sync qps ratio "
              f"{s_off / s_on:.4f} ({n / s_on:.1f} vs {n / s_off:.1f} qps), "
              f"burst qps ratio {b_off / b_on:.4f} ({n / b_on:.1f} vs "
              f"{n / b_off:.1f} qps through drain), burst request p99 "
              f"{p99['on']:.3f} vs {p99['off']:.3f} ms; the reference's "
              f"gates (DESIGN.md §12, not applied): qps ratio >= 0.97, p99 "
              f"<= 1.25x + 2 ms")
    for srv in servers.values():
        srv.stop_async()


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
                 dev, by_path: dict, staged: dict) -> None:
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
    staged[label] = eng
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
    parsed = export_round_trips(obs.REGISTRY)
    eng_id = eng.shard_stats()[0].labels["eng"]
    slots = {int(dict(k)["shard"]): v
             for k, v in parsed["shard_slots_total"].items()
             if dict(k)["eng"] == eng_id}
    require(slots == {st.shard: st.slots for st in srv.stats.per_shard}
            and sorted(slots) == list(range(SHARDS)),
            f"exported shard_slots_total {slots}")
    print(f"check: {label}: exported shard_slots_total for shards "
          f"{sorted(slots)} = the per-shard views {list(slots.values())}")
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
    staged[f"{label} bf16"] = qeng
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


def _leaves(tree):
    """The tensors of a nested dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def lm_step_bytes(cfg, params: dict, B: int, max_len: int,
                  cache_elem: int) -> dict:
    """Bytes one greedy decode step must move: every parameter the step
    reads once (an untied embedding table only its B gathered rows; the
    MTP head and the encoder not at all), the attention cache's slabs read
    once (every slot of max_len: the step masks, it does not skip), the
    float32 logits written once."""
    emb = params["embed"]
    read = {k: v for k, v in params.items()
            if k not in ("mtp_proj", "mtp_block", "encoder")}
    if not cfg.tie_embeddings:
        read.pop("embed")
    weights = sum(t.numel() * t.element_size() for t in _leaves(read))
    gather = 0 if cfg.tie_embeddings else B * cfg.d_model * \
        emb.element_size()
    kv = 0
    if cfg.attn == "gqa":
        kv = cfg.n_layers * 2 * B * max_len * cfg.n_kv_heads * \
            cfg.head_dim * cache_elem
    logits = B * cfg.vocab * 4
    return {"weights": weights, "gather": gather, "cache": kv,
            "logits": logits, "total": weights + gather + kv + logits}


def lm_close(got, want, rtol: float, atol: float) -> bool:
    """allclose with atol scaled by the larger of 1 and want's largest
    magnitude: a float32 logit is a sum of products whose rounding is
    relative to the terms, not to the sum (the CPU parity tests' rule)."""
    import torch

    scale = max(1.0, float(want.abs().max()))
    return torch.allclose(got, want, rtol=rtol, atol=atol * scale)


def lm_kernel_launches(kernels: dict, label: str, by_path: dict) -> None:
    """The LM path launches none of the EHL kernels: record its counts
    (set to 0 just before the path) and require them all 0."""
    launches = {n: k.launches for n, k in kernels.items()}
    by_path[label] = launches
    require(not any(launches.values()),
            f"the {label} path launched an EHL kernel: {launches}")
    print(f"launches: {label}: " + ", ".join(
        f"{n} {c}" for n, c in launches.items()))


def full_f32_matmuls() -> None:
    """float32 matmuls in full precision for every f32 check (no TF32)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 is on for float32 matmuls")


def lm_full_width(dev, kernels: dict, by_path: dict) -> None:
    """tinyllama-1.1b at its published width through the port's LM path:
    f32 decode == forward (B=2, S=32; the reference test's rtol 2e-3, atol
    2e-4), the card == the CPU (B=1, S=8; rtol 1e-4, atol 1e-4), then the
    bf16 LMServer at each batch of LM_BATCHES: ms per decode step (median
    of LM_PASSES passes of LM_NEW tokens after a stepped LM_PROMPT-token
    prompt), tokens/s, peak memory, one profiled step (device ms, device
    ops, idle share) and the step's bytes over the HBM rate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import LMServer

    full_f32_matmuls()
    cfg = get_config(LM_ARCH)
    label = f"{LM_ARCH} LM"
    print(f"path: {label} (full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"random init, seed {LM_SEED})")
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    p32 = T.init_params(cfg, gen, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(p32))
    print(f"lm: init f32 on the card {time.perf_counter() - t0:.3f} s, "
          f"{n_params} parameters, {4 * n_params} bytes")
    rng = np.random.default_rng(LM_SEED)

    # f32: stepped decode == forward (the reference's decode test)
    B, S = 2, 32
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)
    with torch.no_grad():
        full = T.forward(cfg, p32, toks)
        cache = T.init_cache(cfg, B, S, dtype=torch.float32, device=dev)
        outs = []
        for i in range(S):
            lg, cache = T.decode_step(cfg, p32, cache, toks[:, i:i + 1])
            outs.append(lg)
        dec = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(full).all()) and full.shape == (B, S,
                                                                cfg.vocab),
            "f32 forward logits not finite or of the wrong shape")
    require(torch.allclose(dec, full, rtol=2e-3, atol=2e-4),
            f"f32 decode != forward: max abs {max_abs_err(dec, full)}")
    print(f"check: {label} f32 decode == forward at B={B}, S={S} (rtol "
          f"2e-3, atol 2e-4): max abs err {max_abs_err(dec, full):.3e}, "
          f"logits up to {float(full.abs().max()):.3f}")
    del cache, outs, dec, full

    # the card against the CPU on the same f32 parameters
    B, S = 1, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    pcpu = T.to_device(p32, "cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        want = T.forward(cfg, pcpu, toks)
        got = T.forward(cfg, p32, toks.to(dev)).cpu()
    del pcpu
    abs_err = max_abs_err(got, want)
    top = float(want.abs().max())
    require(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
            f"card forward != CPU forward: max abs {abs_err}")
    print(f"check: {label} card forward == CPU forward at B={B}, S={S} "
          f"(rtol 1e-4, atol 1e-4): max abs err {abs_err:.3e}, "
          f"{abs_err / top:.3e} of the largest |logit| {top:.3f} "
          f"({time.perf_counter() - t0:.2f} s)")

    # the bf16 LMServer: the prompt is stepped into a cache once a batch;
    # decode_step leaves its input cache as it was, so each pass's server
    # starts from that same prefilled cache
    p16 = T.tree_map(lambda a: a.to(torch.bfloat16), p32)
    for B in LM_BATCHES:
        prompt = rng.integers(0, cfg.vocab, (B, LM_PROMPT)).astype(np.int32)
        prompt_t = torch.from_numpy(prompt).to(dev)
        with torch.no_grad():
            top1_f32 = T.prefill(cfg, p32, prompt_t).argmax(-1)[:, 0].cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        srv = LMServer(cfg, p16, T.init_cache(
            cfg, B, LM_MAX_LEN, dtype=torch.bfloat16, device=dev),
            device=dev)
        with torch.no_grad():
            for i in range(LM_PROMPT - 1):
                srv.cache = srv._step(srv.params, srv.cache,
                                      prompt_t[:, i:i + 1])[1]
        prefilled = srv.cache
        torch.cuda.synchronize()
        ms = []
        for _ in range(LM_PASSES):
            srv = LMServer(cfg, p16, prefilled, device=dev)
            out = srv.generate(prompt, LM_NEW)
            ms.append(1e3 * srv.stats.seconds / LM_NEW)
            require(out.shape == (B, LM_NEW) and out.dtype == np.int32
                    and bool(((out >= 0) & (out < cfg.vocab)).all()),
                    f"LMServer tokens at B={B}: shape {out.shape}, range "
                    f"[{out.min()}, {out.max()}]")
            require(srv.stats.queries == B * LM_NEW,
                    f"LMServer counted {srv.stats.queries} queries, not "
                    f"{B * LM_NEW}")
            require(srv.cache["step"] == LM_PROMPT - 1 + LM_NEW
                    and prefilled["step"] == LM_PROMPT - 1,
                    "LMServer cache steps")
        peak = torch.cuda.max_memory_allocated(dev)
        agree = float((torch.from_numpy(out[:, 0]) == top1_f32).float()
                      .mean())
        # one more step: its logits, then the same step under the profiler
        tok = torch.from_numpy(out[:, -1:]).to(dev)
        with torch.no_grad():
            lg, _ = srv._step(srv.params, srv.cache, tok)
            torch.cuda.synchronize()
            require(lg.shape == (B, 1, cfg.vocab) and lg.dtype ==
                    torch.float32 and bool(torch.isfinite(lg).all()),
                    f"bf16 step logits at B={B}: {lg.shape}, {lg.dtype}")
            with profiler() as prof:
                t0 = time.perf_counter()
                srv._step(srv.params, srv.cache, tok)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
        dev_ops = device_times(prof)
        busy = sum(us for _, us in dev_ops.values()) / 1e3
        n_ops = sum(c for c, _ in dev_ops.values())
        step = float(np.median(ms))
        need = lm_step_bytes(cfg, p16, B, LM_MAX_LEN, 2)
        bound = 1e3 * need["total"] / HBM_BYTES_PER_S
        print(f"lm: {label} bf16 LMServer B={B}: {step:.4f} ms per decode "
              f"step (median of {LM_PASSES} passes of {LM_NEW} tokens: "
              f"{', '.join(f'{m:.4f}' for m in ms)}), "
              f"{1e3 * B / step:.1f} tokens/s, max_memory_allocated {peak} "
              f"bytes; top-1 of the first token == f32's on {agree:.3f} of "
              f"rows")
        print(f"lm: {label} B={B} profiled step: wall {wall:.4f} ms, "
              f"device {busy:.4f} ms in {n_ops} device ops, idle share "
              f"{1 - busy / wall:.4f}")
        print(f"lm: {label} B={B} bound: {need['weights']} weight bytes "
              f"({1e3 * need['weights'] / HBM_BYTES_PER_S:.4f} ms) + "
              f"{need['gather']} embedding rows + {need['cache']} cache "
              f"bytes + {need['logits']} logit bytes = {need['total']} "
              f"bytes, {bound:.4f} ms at {HBM_BYTES_PER_S:.3g} B/s; the "
              f"measured step is {step / bound:.2f}x the bound "
              f"({bound / step:.4f} of it)")
        del srv, lg, prefilled
    del p16, p32
    torch.cuda.empty_cache()
    lm_kernel_launches(kernels, label, by_path)


def lm_families(dev, kernels: dict, by_path: dict) -> None:
    """The ten architectures' reduced configs on the card: forward logits
    == the CPU's on the same f32 parameters (rtol 1e-4, atol 1e-5 times the
    larger of 1 and the logits' largest magnitude, as the CPU parity tests
    hold the port to the reference), and for the six decode
    representatives stepped decode == forward on the card (rtol 2e-3, atol
    2e-4)."""
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import transformer as T

    full_f32_matmuls()
    label = "LM families"
    print(f"path: {label}, reduced")
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, LM_SEED, dtype=torch.float32,
                               device="cpu")
        rng = np.random.default_rng(LM_SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
        enc = (torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
            if cfg.encdec else None)
        pdev = T.to_device(params, dev)
        with torch.no_grad():
            want = T.forward(cfg, params, toks, enc_frames=enc)
            got = T.forward(cfg, pdev, toks.to(dev), enc_frames=None
                            if enc is None else enc.to(dev))
        require(lm_close(got.cpu(), want, 1e-4, 1e-5),
                f"{arch} reduced: card forward != CPU forward, max abs "
                f"{max_abs_err(got.cpu(), want)}")
        line = (f"check: {arch} reduced card forward == CPU (rtol 1e-4, "
                f"atol 1e-5 x {max(1.0, float(want.abs().max())):.3f}): "
                f"max abs err {max_abs_err(got.cpu(), want):.3e}")
        if arch in LM_DECODE_ARCHS:
            S = 16
            t = toks[:, :S].to(dev)
            e = None if enc is None else enc.to(dev)
            with torch.no_grad():
                full = T.forward(cfg, pdev, t, enc_frames=e)
                enc_out = T.encode(cfg, pdev, e) if cfg.encdec else None
                cache = T.init_cache(cfg, 2, S, dtype=torch.float32,
                                     enc_out=enc_out, params=pdev,
                                     device=dev)
                outs = []
                for i in range(S):
                    lg, cache = T.decode_step(cfg, pdev, cache, t[:, i:i + 1])
                    outs.append(lg)
                dec = torch.cat(outs, dim=1)
            require(torch.allclose(dec, full, rtol=2e-3, atol=2e-4),
                    f"{arch} reduced: decode != forward on the card, max "
                    f"abs {max_abs_err(dec, full)}")
            line += (f"; decode == forward on the card (rtol 2e-3, atol "
                     f"2e-4): max abs err {max_abs_err(dec, full):.3e}")
        print(line)
    torch.cuda.synchronize()
    print(f"lm: {label}: {len(ARCH_IDS)} architectures in "
          f"{time.perf_counter() - t0:.2f} s")
    lm_kernel_launches(kernels, label, by_path)


def tree_errors(got: dict, want: dict, rtol: float, atol: float,
                floor: float) -> float:
    """Require every leaf of ``got`` (flattened, on the card) within rtol
    and atol times its scale of ``want``'s (on the CPU), the scale the
    larger of ``floor`` and the leaf's largest |value|; returns the largest
    |error| / scale."""
    import torch

    worst = 0.0
    require(sorted(got) == sorted(want), "gradient trees differ in keys")
    for k, w in want.items():
        g = got[k].cpu()
        scale = max(floor, float(w.abs().max()))
        require(torch.allclose(g, w, rtol=rtol, atol=atol * scale),
                f"gradient {k}: card != CPU, max abs {max_abs_err(g, w)} "
                f"(scale {scale})")
        worst = max(worst, max_abs_err(g, w) / scale if scale else 0.0)
    return worst


def train_steps(step_fn, params, state, dcfg, steps: int, dev):
    """``steps`` train steps on ``synthetic_batch``: (params, state,
    losses, wall ms of each step, the step's metrics)."""
    import torch

    from repro_torch.data.pipeline import synthetic_batch

    losses, ms = [], []
    for i in range(steps):
        batch = torch.from_numpy(synthetic_batch(dcfg, i)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
        require(np.isfinite(losses[-1]), f"train step {i}: loss {losses[-1]}")
    return params, state, losses, ms, m


def lm_train_full_width(dev, kernels: dict, by_path: dict) -> None:
    """tinyllama-1.1b trained at its published width: card == CPU loss and
    every gradient leaf at B=1, S=16 (f32, TF32 off); then LM_TRAIN_STEPS
    steps at B=LM_TRAIN_BATCH, S=LM_TRAIN_SEQ from ``synthetic_batch``,
    f32 parameters and moments, remat "full", ce_chunk 512: the last loss
    below the first, ms per step (median after the first two), tokens/s,
    ``max_memory_allocated``, one profiled step and the step against 8·N·T
    FLOP over the float32 peak; then the same steps with bf16 parameters
    (``--dtype bfloat16``: float32 moments) against the bf16 peak."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.launch.train import build_train_step, loss_and_grads
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    full_f32_matmuls()
    cfg = dataclasses.replace(get_config(LM_ARCH), remat="full",
                              ce_chunk=512)
    label = f"{LM_ARCH} train"
    print(f"path: {label} (full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; random init, seed {LM_SEED}; "
          f"remat {cfg.remat}, ce_chunk {cfg.ce_chunk})")
    for k in kernels.values():
        k.launches = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    p32 = T.init_params(cfg, gen, dtype=torch.float32, device=dev)
    n_params = sum(t.numel() for t in _leaves(p32))

    # the card against the CPU: loss and every gradient leaf, B=1, S=16
    rng = np.random.default_rng(LM_SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)).astype(
        np.int32))
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(cfg, T.to_device(p32, "cpu"), toks)
    cpu_s = time.perf_counter() - t0
    got_loss, got = loss_and_grads(cfg, p32, toks.to(dev))
    want, got = flatten(want), flatten(got)
    lerr = abs(float(got_loss) - float(want_loss))
    require(lerr <= 1e-5 * abs(float(want_loss)),
            f"card loss {float(got_loss)} != CPU loss {float(want_loss)}")
    worst = tree_errors(got, want, LM_GRAD_RTOL, LM_GRAD_ATOL, 0.0)
    print(f"check: {label} card == CPU at B=1, S=16 (f32, TF32 off): loss "
          f"{float(want_loss):.6f}, |error| {lerr:.3e} (rtol 1e-5); "
          f"{len(want)} gradient leaves within rtol {LM_GRAD_RTOL:g}, atol "
          f"{LM_GRAD_ATOL:g} x each leaf's largest |value|: largest "
          f"|error| / that scale {worst:.3e} (CPU {cpu_s:.1f} s)")
    del want, got

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                      global_batch=LM_TRAIN_BATCH, seed=LM_SEED)
    ocfg = adamw.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=5,
                             total_steps=LM_TRAIN_STEPS)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flop = 8 * n_params * tokens     # forward, full-remat recompute, backward
    runs = (("f32", torch.float32, F32_PEAK_FLOPS,
             "float32 outside the tensor cores, TF32 off"),
            ("bf16", torch.bfloat16, BF16_PEAK_FLOPS,
             "bf16 on the tensor cores, dense"))
    for name, dtype, peak, peak_name in runs:
        params = T.tree_map(lambda a: a.to(dtype), p32)
        if dtype == torch.bfloat16:
            del p32
        state = adamw.init_state(params, ocfg)
        step = build_train_step(cfg, ocfg)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, losses, ms, m = train_steps(
            step, params, state, dcfg, LM_TRAIN_STEPS, dev)
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        require(losses[-1] < losses[0],
                f"{label} {name}: loss did not fall: {losses}")
        med = float(np.median(ms[2:]))
        # one more step under the profiler
        batch = torch.from_numpy(synthetic_batch(dcfg, LM_TRAIN_STEPS)).to(
            dev)
        torch.cuda.synchronize()
        with profiler() as prof:
            t0 = time.perf_counter()
            params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev_ops = device_times(prof)
        busy = sum(us for _, us in dev_ops.values()) / 1e3
        n_ops = sum(c for c, _ in dev_ops.values())
        bound = 1e3 * flop / peak
        print(f"lm: {label} {name}: losses " + ", ".join(
            f"{x:.4f}" for x in losses) + f" (lr {LM_TRAIN_LR:g}, warmup 5; "
              f"gnorm {float(m['grad_norm']):.3f} at the last step)")
        print(f"lm: {label} {name} B={LM_TRAIN_BATCH} S={LM_TRAIN_SEQ}: "
              f"{med:.4f} ms per step (median of steps 3-{LM_TRAIN_STEPS}; "
              f"first two {ms[0]:.1f}, {ms[1]:.1f} ms), "
              f"{1e3 * tokens / med:.1f} tokens/s, max_memory_allocated "
              f"{peak_bytes} bytes")
        print(f"lm: {label} {name} profiled step: wall {wall:.4f} ms, device "
              f"{busy:.4f} ms in {n_ops} device ops, idle share "
              f"{1 - busy / wall:.4f}")
        gemm = sum(us for k, (_, us) in dev_ops.items()
                   if any(t in k.lower() for t in GEMM_KERNEL_TAGS)) / 1e3
        top = sorted(dev_ops.items(), key=lambda kv: -kv[1][1])[:5]
        # (a session whose device events the profiler dropped has busy 0)
        share = gemm / busy if busy else float("nan")
        print(f"lm: {label} {name} profiled step by kernel: matmul kernels "
              f"{gemm:.4f} ms ({share:.4f} of device time); largest: "
              + "; ".join(f"{k[:72]} {us / 1e3:.4f} ms in {c}"
                          for k, (c, us) in top))
        print(f"lm: {label} {name} bound: 8·N·T = 8 x {n_params} x {tokens} "
              f"= {flop:.4e} FLOP over the {name} peak {peak:.3g} FLOP/s "
              f"({peak_name}; H100 SXM data sheet) = {bound:.4f} ms; the "
              f"measured step is "
              f"{med / bound:.2f}x the bound ({bound / med:.4f} of it)")
        del params, state, step
    torch.cuda.empty_cache()
    lm_kernel_launches(kernels, label, by_path)


def batch_sharded_path(bx, index, dense_got, s, t, qs, kernels, twins,
                       dev, by_path: dict, staged: dict) -> None:
    """Data-parallel EHL serving: ``PathServer(mesh=(cuda:0, cuda:0),
    batch_sharding="rows")`` on the rooms-M dense artifact, every batch two
    row blocks on the one card's replica, driven like the other paths:
    answers == the dense server's bit for bit, nothing cold on live
    traffic, kernels launched and no twin called."""
    from repro_torch.serving import CudaEngine, PathServer, TorchEngine
    from repro_torch.serving.engine import BATCH_ROWS

    label = f"{MAP} batch-sharded"
    mesh = (dev, dev)
    print(f"path: {label} (mesh {[str(d) for d in mesh]}, batch {BATCH} "
          f"in {len(mesh)} row blocks of {BATCH // len(mesh)})")
    srv = PathServer(CudaEngine(bx), batch_size=BATCH, mesh=mesh,
                     batch_sharding=BATCH_ROWS)
    staged[label] = srv
    run = drive(srv, s, t, index, kernels, twins, label)
    by_path[label] = run["launches"]
    require(run["launches"]["segvis"] > 0
            and run["launches"]["label_join_rowmin"] > 0,
            f"a kernel of the {label} path never launched: {run['launches']}")
    twin = PathServer(TorchEngine(bx), batch_size=BATCH, mesh=mesh,
                      batch_sharding=BATCH_ROWS)
    got = check_answers(srv, twin, run, s, t, index, qs)
    for name, a, b in zip(ANSWERS, got, dense_got):
        require(np.array_equal(a, b), f"{label} vs dense output {name}")
    try:
        srv.start_async()
        require(False, "start_async ran under batch_sharding")
    except ValueError:
        pass
    print(f"check: {label} == dense CudaEngine on all 5 outputs "
          f"({len(s)} queries); start_async refused")


def mesh_step_stats(step, params, state, dcfg, batch_of, dev) -> dict:
    """MESH_STEPS steps, then one profiled: losses, ms per step (median
    after the first), peak bytes, the profiled step's wall and device ms."""
    import torch

    from repro_torch.launch.train import host_float

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms = [], []
    for i in range(MESH_STEPS):
        batch = batch_of(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(host_float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        require(np.isfinite(losses[-1]), f"mesh train step {i}: loss "
                f"{losses[-1]}")
    peak = torch.cuda.max_memory_allocated(dev)
    batch = batch_of(MESH_STEPS)
    torch.cuda.synchronize()
    with profiler() as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(us for _, us in device_times(prof).values()) / 1e3
    return dict(params=params, losses=losses, ms=float(np.median(ms[1:])),
                first_ms=ms[0], peak=peak, wall=wall, busy=busy)


def lm_mesh_train(dev, kernels: dict, by_path: dict) -> None:
    """tinyllama-1.1b trained on a one-rank NCCL ("data", "model") mesh:
    DTensor parameters placed by ``param_shardings``, batches from
    ``global_batch_arrays``; losses and one step's gradients against the
    one-device step on the same seed and batches; then a checkpoint of the
    mesh parameters restored with ``restore(mesh=)``, leaf bits equal."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, global_batch_arrays,
                                           synthetic_batch)
    from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                  param_shardings,
                                                  undistribute)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import (build_train_step, loss_and_grads,
                                          on_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    full_f32_matmuls()
    cfg = dataclasses.replace(get_config(LM_ARCH), remat="full",
                              ce_chunk=512)
    mesh = make_host_mesh(device=dev)
    label = f"{LM_ARCH} mesh train"
    print(f"path: {label} (mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
          f" on NCCL, one rank; full width, B={LM_TRAIN_BATCH}, "
          f"S={LM_TRAIN_SEQ}, seed {LM_SEED})")
    for k in kernels.values():
        k.launches = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    p32 = T.init_params(cfg, gen, dtype=torch.float32, device=dev)
    shard = param_shardings(p32, mesh)
    bspec = batch_spec(mesh)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                      global_batch=LM_TRAIN_BATCH, seed=LM_SEED)
    ocfg = adamw.AdamWConfig(lr=LM_TRAIN_LR, warmup_steps=5,
                             total_steps=LM_TRAIN_STEPS)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ

    # one step's gradients, f32: the mesh against one device
    toks = torch.from_numpy(synthetic_batch(dcfg, 0)).to(dev)
    want_loss, want = loss_and_grads(cfg, p32, toks)
    want = {k: v.cpu() for k, v in flatten(want).items()}
    dp = distribute(p32, mesh, shard)
    with on_mesh(mesh):
        got_loss, got = loss_and_grads(cfg, dp, global_batch_arrays(
            dcfg, 0, mesh, bspec))
    got = {k: v.cpu() for k, v in flatten(undistribute(got)).items()}
    got_loss = got_loss.full_tensor()
    same = sum(torch.equal(got[k], want[k]) for k in want)
    worst = tree_errors(got, want, LM_GRAD_RTOL, LM_GRAD_ATOL, 0.0)
    require(abs(float(got_loss) - float(want_loss))
            <= MESH_LOSS_RTOL["f32"] * abs(float(want_loss)),
            f"mesh loss {float(got_loss)} != one-device {float(want_loss)}")
    print(f"check: {label} gradients, f32 (TF32 off), batch 0: loss "
          f"{float(got_loss):.6f} vs one device {float(want_loss):.6f} "
          f"({'bit-equal' if float(got_loss) == float(want_loss) else 'differ'}"
          f"); {same} of {len(want)} gradient leaves bit-equal; all within "
          f"rtol {LM_GRAD_RTOL:g} + atol {LM_GRAD_ATOL:g} x each leaf's "
          f"largest |value| (largest |error| / scale {worst:.3e})")
    del want, got, dp

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        params = T.tree_map(lambda a: a.to(dtype), p32)
        one = mesh_step_stats(
            build_train_step(cfg, ocfg), params, adamw.init_state(params, ocfg),
            dcfg, lambda i: torch.from_numpy(synthetic_batch(dcfg, i)).to(dev),
            dev)
        del one["params"]
        dp = distribute(params, mesh, shard)
        del params
        on = mesh_step_stats(
            build_train_step(cfg, ocfg, mesh=mesh), dp,
            adamw.init_state(dp, ocfg), dcfg,
            lambda i: global_batch_arrays(dcfg, i, mesh, bspec), dev)
        rtol = MESH_LOSS_RTOL[name]
        require(np.allclose(on["losses"], one["losses"], rtol=rtol, atol=0),
                f"{label} {name}: losses {on['losses']} vs one device "
                f"{one['losses']} (rtol {rtol:g})")
        bit = on["losses"] == one["losses"]
        print(f"check: {label} {name}: losses " + ", ".join(
            f"{x:.6f}" for x in on["losses"]) + " vs one device " + ", ".join(
            f"{x:.6f}" for x in one["losses"]) + f" (rtol {rtol:g}; "
            f"{'bit-equal' if bit else 'not bit-equal'})")
        for what, r in (("mesh", on), ("one device", one)):
            print(f"lm: {label} {name} {what}: {r['ms']:.4f} ms per step "
                  f"(median of steps 2-{MESH_STEPS}; first {r['first_ms']:.1f}"
                  f" ms), {1e3 * tokens / r['ms']:.1f} tokens/s, "
                  f"max_memory_allocated {r['peak']} bytes; profiled step: "
                  f"wall {r['wall']:.4f} ms, device {r['busy']:.4f} ms, idle "
                  f"share {1 - r['busy'] / r['wall']:.4f}")
        if name == "bf16":
            ckpt = ROOT / "build" / "chip_smoke_mesh"
            shutil.rmtree(ckpt, ignore_errors=True)
            t0 = time.perf_counter()
            store.save(str(ckpt), 0, {"p": on["params"]})
            back = store.restore(str(ckpt), 0, {"p": on["params"]},
                                 mesh=mesh)
            fs, fb = flatten(on["params"]), flatten(back["p"])
            for k, v in fs.items():
                a, b = v.full_tensor(), fb[k].full_tensor()
                require(a.dtype == b.dtype and torch.equal(
                    a.view(torch.int16), b.view(torch.int16)),
                        f"checkpoint leaf {k} changed through the store")
            print(f"check: {label} bf16 checkpoint: {len(fs)} DTensor "
                  f"leaves saved and restored with restore(mesh=) bit for "
                  f"bit ({time.perf_counter() - t0:.1f} s)")
            shutil.rmtree(ckpt, ignore_errors=True)
        del on, dp
        torch.cuda.empty_cache()
    del p32
    torch.cuda.empty_cache()
    lm_kernel_launches(kernels, label, by_path)


def flash_decode_path(dev, kernels: dict, by_path: dict) -> None:
    """``decode_attention_dist`` on a one-rank mesh at tinyllama's decode
    width against ``decode_attention`` plus the slot write."""
    import torch

    from repro_torch.distributed import hints
    from repro_torch.distributed.flash_decode import decode_attention_dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as ll

    mesh = make_host_mesh(device=dev)
    label = "flash decode"
    B, Smax, H, K, hd = (FLASH_SHAPE[k] for k in ("B", "Smax", "H", "K",
                                                   "hd"))
    print(f"path: {label} (decode_attention_dist, one-rank mesh, B={B}, "
          f"Smax={Smax}, H={H}, K={K}, hd={hd}, bf16)")
    for k in kernels.values():
        k.launches = 0
    g = torch.Generator(device=dev)
    g.manual_seed(LM_SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q, kc, vc = rnd(B, 1, H, hd), rnd(B, Smax, K, hd), rnd(B, Smax, K, hd)
    kn, vn = rnd(B, 1, K, hd), rnd(B, 1, K, hd)
    for pos, w, cap in FLASH_CASES:
        def dist():
            with hints.mesh_hints(mesh):
                return decode_attention_dist(q, kc, vc, kn, vn, pos,
                                             window=w, softcap=cap)

        def plain():
            kr, vr = kc.clone(), vc.clone()
            kr[:, pos], vr[:, pos] = kn[:, 0], vn[:, 0]
            return ll.decode_attention(q, kr, vr, pos + 1, window=w,
                                       softcap=cap), kr, vr

        (od, kd, vd), (op, kp, vp) = dist(), plain()
        require(torch.equal(kd, kp) and torch.equal(vd, vp),
                f"{label} pos {pos}: the written caches differ")
        require(torch.allclose(od.float(), op.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL),
                f"{label} pos {pos}: output differs by "
                f"{max_abs_err(od.float(), op.float())}")
        ms_d, ms_p = cuda_ms(dist, 20), cuda_ms(plain, 20)
        print(f"check: {label} pos={pos} window={w} softcap={cap}: output "
              f"within rtol {BF16_RTOL:g} + atol {BF16_ATOL:g} of plain "
              f"(max |error| {max_abs_err(od.float(), op.float()):.3e}, "
              f"{'bit-equal' if torch.equal(od, op) else 'not bit-equal'}), "
              f"caches bit-equal; {ms_d:.4f} ms (plain {ms_p:.4f} ms)")
    lm_kernel_launches(kernels, label, by_path)


def moe_ep_path(dev, kernels: dict, by_path: dict) -> None:
    """``moe_block_ep`` for one llama4-scout-17b-a16e MoE layer at its
    published width on a one-rank mesh, against ``moe_block`` at the same
    capacity: forward and the weights' gradients, bf16."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.distributed import hints
    from repro_torch.distributed.moe_ep import _round8, moe_block_ep
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten, unflatten

    cfg = get_config(MOE_ARCH)
    mesh = make_host_mesh(device=dev)
    label = f"{MOE_ARCH} moe_block_ep"
    Bm, Sm = MOE_SHAPE
    T_ = Bm * Sm
    cap = _round8(int(T_ * cfg.topk / cfg.n_experts * cfg.capacity_factor))
    for k in kernels.values():
        k.launches = 0
    p = T._layer(ll.init_moe(cfg, ll.ParamInit(dev, LM_SEED), 1,
                             torch.bfloat16), 0)
    nbytes = sum(v.numel() * v.element_size() for v in flatten(p).values())
    print(f"path: {label} (d_model {cfg.d_model}, {cfg.n_experts} experts, "
          f"top-{cfg.topk}, moe_d_ff {cfg.moe_d_ff}, {cfg.n_shared} shared; "
          f"{nbytes} bytes of bf16 weights; {T_} tokens, capacity {cap})")
    g = torch.Generator(device=dev)
    g.manual_seed(LM_SEED)
    x = torch.randn((Bm, Sm, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)

    def ep():
        with hints.mesh_hints(mesh):
            return moe_block_ep(cfg, p, x, cap)

    with CommDebugMode() as comm:
        y_ep = ep()
    a2a = sum(n for op, n in comm.get_comm_counts().items()
              if "all_to_all" in str(op))
    require(a2a == 2, f"{label}: the EP path ran {a2a} all-to-alls, not 2")
    y = ll.moe_block(cfg, p, x, cap)
    require(torch.allclose(y_ep.float(), y.float(), rtol=BF16_RTOL,
                           atol=BF16_ATOL),
            f"{label}: forward differs by {max_abs_err(y_ep, y)}")

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten(p).items()}
        with hints.mesh_hints(mesh):
            loss = (fn(unflatten(leaves)).float() ** 2).mean()
        return dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))

    g_ep = grads(lambda q: moe_block_ep(cfg, q, x, cap))
    g_pl = grads(lambda q: ll.moe_block(cfg, q, x, cap))
    n_grads = len(g_pl)
    worst, same = 0.0, 0
    for k, w in g_pl.items():
        scale = float(w.float().abs().max())
        require(torch.allclose(g_ep[k].float(), w.float(), rtol=BF16_RTOL,
                               atol=BF16_ATOL * scale),
                f"{label}: gradient {k} differs")
        worst = max(worst, max_abs_err(g_ep[k].float(), w.float())
                    / max(scale, 1e-30))
        same += torch.equal(g_ep[k], w)
    del g_ep, g_pl
    ms_ep, ms_pl = cuda_ms(ep, 5), cuda_ms(
        lambda: ll.moe_block(cfg, p, x, cap), 5)
    fb_ep = cuda_ms(lambda: grads(lambda q: moe_block_ep(cfg, q, x, cap)), 3)
    fb_pl = cuda_ms(lambda: grads(lambda q: ll.moe_block(cfg, q, x, cap)), 3)
    print(f"check: {label}: 2 all-to-alls; forward within rtol "
          f"{BF16_RTOL:g} + atol {BF16_ATOL:g} of moe_block (max |error| "
          f"{max_abs_err(y_ep.float(), y.float()):.3e}, "
          f"{'bit-equal' if torch.equal(y_ep, y) else 'not bit-equal'}); "
          f"{same} of {n_grads} weight "
          f"gradients bit-equal, all within rtol {BF16_RTOL:g} + atol "
          f"{BF16_ATOL:g} x scale (largest |error| / scale {worst:.3e})")
    print(f"lm: {label}: forward {ms_ep:.4f} ms (moe_block {ms_pl:.4f} ms); "
          f"forward + backward {fb_ep:.4f} ms (moe_block {fb_pl:.4f} ms)")
    del p, x, y, y_ep
    torch.cuda.empty_cache()
    lm_kernel_launches(kernels, label, by_path)


def pipeline_path(dev, kernels: dict, by_path: dict) -> None:
    """``pipeline_forward`` with one stage over the full tinyllama stack
    against ``forward_hidden`` (f32, TF32 off)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import hints
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.models import transformer as T

    full_f32_matmuls()
    cfg = get_config(LM_ARCH)
    mesh = make_mesh((1, 1), ("pod", "data"), device=dev)
    label = f"{LM_ARCH} pipeline"
    print(f"path: {label} (one stage of {cfg.n_layers} layers, "
          f"B={LM_TRAIN_BATCH}, S={LM_TRAIN_SEQ}, {PIPE_MICRO} microbatches, "
          f"f32)")
    for k in kernels.values():
        k.launches = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(LM_SEED)
    params = T.init_params(cfg, gen, dtype=torch.float32, device=dev)
    toks = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ))).to(dev)

    def pp():
        with torch.no_grad(), hints.mesh_hints(mesh):
            return pipeline_forward(cfg, params, toks, n_micro=PIPE_MICRO)

    def plain():
        with torch.no_grad():
            return T.forward_hidden(cfg, params, toks)

    got, want = pp(), plain()
    scale = float(want.abs().max())
    require(torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale),
            f"{label}: hidden state differs by {max_abs_err(got, want)}")
    ms_pp, ms_pl = cuda_ms(pp, 3), cuda_ms(plain, 3)
    print(f"check: {label} == forward_hidden within rtol 1e-4 + atol 1e-4 x "
          f"{scale:.3f} (max |error| {max_abs_err(got, want):.3e}, "
          f"{'bit-equal' if torch.equal(got, want) else 'not bit-equal'}); "
          f"{ms_pp:.4f} ms (forward_hidden {ms_pl:.4f} ms)")
    del params, got, want
    torch.cuda.empty_cache()
    lm_kernel_launches(kernels, label, by_path)


def dryrun_cells() -> None:
    """The fake-rank dry run's cells, each in a process of its own (one
    default process group per process), all started together."""
    import os

    out = ROOT / "build" / "dryrun_torch"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    t0 = time.perf_counter()
    for arch, shape, mesh in DRYRUN_CELLS:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.perf_counter() - t0
    for (arch, shape, mesh), p, (so, se) in zip(DRYRUN_CELLS, procs, outs):
        require(p.returncode == 0, f"dry run {arch} {shape} {mesh} exited "
                f"{p.returncode}: {so[-1500:]} {se[-1500:]}")
        rec = json.loads((out / f"{arch}__{shape}__{mesh}.json").read_text())
        require(rec["status"] == "ok", f"dry run {arch} {shape}: {rec}")
        c = rec["collectives"]
        print(f"dryrun: {arch} {shape} {mesh} ({rec['ranks']} fake ranks, "
              f"{rec['n_layers']} layers): {rec['seconds']:.1f} s; per rank "
              f"params {rec['param_bytes_per_rank']} bytes, optimizer "
              f"{rec['opt_bytes_per_rank']}, cache "
              f"{rec['cache_bytes_per_rank']}, peak live "
              f"{rec['peak_live_bytes']}; flops per rank "
              f"{rec['flops_per_rank']:.4e}; collectives "
              f"{json.dumps(c['counts'])}, bytes "
              f"{json.dumps(c['bytes'])}, all-reduce ops "
              f"{json.dumps(c['all_reduce_ops'])}")
    print(f"dryrun: {len(DRYRUN_CELLS)} cells in {wall:.1f} s wall, "
          f"started together")


def lint_phase() -> None:
    """The port's invariant pass (``repro_torch.analysis``) over this
    checkout's ``src/repro_torch`` on the card machine's Python: 0 findings
    required; the markers by rule and the host seconds printed."""
    from repro_torch import analysis

    t0 = time.perf_counter()
    project = analysis.load_project([str(ROOT / "src" / "repro_torch")],
                                    root=str(ROOT))
    findings = analysis.run(project)
    seconds = time.perf_counter() - t0
    markers: dict = {}      # the pass's own docstrings show the syntax
    for mod in project.modules:
        if mod.name.startswith("repro_torch.analysis"):
            continue
        for line, names in mod.suppressions.items():
            for name in names:
                key = name if line else f"{name} (file)"
                markers[key] = markers.get(key, 0) + 1
    for f in findings:
        print(f"  {f.render()}")
    print(f"lint: python -m repro_torch.analysis src/repro_torch: "
          f"{len(findings)} findings over {len(project.modules)} modules, "
          f"rules {[r.name for r in analysis.rules()]}, markers by rule "
          f"{dict(sorted(markers.items()))}, host {seconds:.3f} s")
    require(not findings, f"the port's invariant pass found {len(findings)}")


def sync_probe() -> dict:
    """{wait: syncs reported}: which explicit waits the sync debug mode
    reports on this build (a stream's, an event's, the device's)."""
    import torch

    from repro_torch.analysis.syncs import record_syncs

    ev = torch.cuda.Event()
    ev.record()
    stream = torch.cuda.current_stream()
    return {name: len(record_syncs(fn)[1]) for name, fn in (
        ("Stream.synchronize", stream.synchronize),
        ("Event.synchronize", ev.synchronize),
        ("torch.cuda.synchronize", torch.cuda.synchronize))}


def padded_batches(eng, s, t, rows: int):
    """(key, s, t) of the batches a server would dispatch: per routing key
    in key order, ``rows`` queries at a time, zero-padded."""
    keys = eng.buckets_of(s, t)
    for k in np.unique(keys):
        idx = np.nonzero(keys == k)[0]
        for lo in range(0, len(idx), rows):
            sel = idx[lo:lo + rows]
            sb = np.zeros((rows, 2), np.float32)
            tb = np.zeros((rows, 2), np.float32)
            sb[:len(sel)], tb[:len(sel)] = s[sel], t[sel]
            yield int(k), sb, tb


def free_slots_settled(engines: list, rows: int) -> tuple:
    """(free pinned slots, those whose copy events have completed) of
    ``engines`` at batch ``rows``: the claim of the ``_slot`` markers, that
    a free slot's wait returns at once."""
    free = done = 0
    for eng in engines:
        pool_of = getattr(eng, "router", eng)._slots
        for slot in pool_of.get(rows, []):
            if slot.busy:
                continue
            evs = slot.copied.values() if isinstance(slot.copied, dict) \
                else [slot.copied]
            free += 1
            done += all(ev.query() for ev in evs)
    return free, done


def syncs_phase(engines: dict, s, t, kernels: dict, by_path: dict) -> None:
    """The dynamic complement of the lint's ``hot-path-sync`` rule: one
    batch's ``stage`` + ``dispatch_staged`` on each warmed engine (both
    argmin modes on f32; on a quantized engine an argmin batch the rescue
    skips and one it takes) under ``torch.cuda.set_sync_debug_mode("warn")``,
    every reported sync attributed to the innermost frame of
    ``repro_torch.serving``/``.sharding`` (``analysis.syncs``).  Required:
    no sync on the f32 engines, every sync at a line the static pass marks
    for ``hot-path-sync`` (or the line after a marker), the free slots'
    copy events complete before staging, and the answers equal the
    synchronous call's bit for bit."""
    from repro_torch.analysis.syncs import port_project, record_syncs, \
        unmarked
    from repro_torch.serving import PathServer

    t0 = time.perf_counter()
    project = port_project()
    probe = sync_probe()
    print("syncs: the sync debug mode reports " + ", ".join(
        f"{name} {'yes' if n else 'no'}" for name, n in probe.items()))
    for k in kernels.values():
        k.launches = 0
    settled = [0, 0]

    def stage_and_dispatch(eng, sb, tb, key, argmin):
        """The engines' pending results of one batch, staged and dispatched
        (a row block per replica under batch sharding)."""
        reps = eng._replicas if isinstance(eng, PathServer) else [eng]
        r = len(sb) // len(reps)
        for n, v in enumerate(free_slots_settled(reps, r)):
            settled[n] += v
        return [rep.dispatch_staged(rep.stage(sb[i * r:(i + 1) * r],
                                              tb[i * r:(i + 1) * r], key),
                                    key, argmin)
                for i, rep in enumerate(reps)]

    total = 0
    for label, eng in engines.items():
        base = eng.engine if isinstance(eng, PathServer) else eng
        quantized = getattr(base, "quantized", False)
        cases = []
        for key, sb, tb in padded_batches(base, s, t, BATCH):
            if not quantized:
                cases = [(key, sb, tb, False, ""), (key, sb, tb, True, "")]
                break
            rows = base.rescue_rows
            base.batch_argmin(sb, tb, key)
            what = "rescued" if base.rescue_rows > rows else "no rescue"
            if what not in {c[4] for c in cases}:
                cases.append((key, sb, tb, True, what))
            if len(cases) == 2:
                break
        cols = []
        for key, sb, tb, argmin, what in cases:
            pend, sites = record_syncs(stage_and_dispatch, eng, sb, tb,
                                       key, argmin)
            got = tuple(np.concatenate(c) for c in zip(
                *[p.wait() for p in pend]))
            want = base.batch_argmin(sb, tb, key) if argmin \
                else (base.batch(sb, tb, key),)
            for name, a, b in zip(ANSWERS, got, want):
                require(np.array_equal(a, b),
                        f"syncs: {label} staged != sync output {name}")
            bad = unmarked(sites, project)
            where: dict = {}
            for site in sites:
                where[site.render()] = where.get(site.render(), 0) + 1
            cols.append(f"argmin={argmin}{' ' + what if what else ''} key "
                        f"{key}: {len(sites)}" + (" at " + ", ".join(
                            f"{w} x{n}" for w, n in where.items())
                            if sites else ""))
            require(not bad, f"syncs: {label}: a sync at an unmarked line: "
                    f"{[x.render() for x in bad]}")
            require(quantized or not sites,
                    f"syncs: the f32 engine {label} synchronised: {where}")
            total += len(sites)
        print(f"syncs: {label}: " + "; ".join(cols))
    by_path["syncs"] = {n: k.launches for n, k in kernels.items()}
    require(by_path["syncs"]["segvis"] > 0
            and by_path["syncs"]["label_join_rowmin"] > 0,
            f"the syncs batches launched {by_path['syncs']}")
    require(settled[0] > 0 and settled[0] == settled[1],
            f"syncs: {settled[1]} of {settled[0]} free slots' copy events "
            "complete before staging")
    print(f"syncs: {total} syncs over {len(engines)} engines, every one at a "
          f"hot-path-sync marker; {settled[1]} of {settled[0]} free slots' "
          f"copy events complete before staging; launches "
          f"{by_path['syncs']}; host {time.perf_counter() - t0:.3f} s")


def quickstart_phase(kernels: dict, by_path: dict) -> None:
    """``examples/quickstart_torch.py``'s ``main`` on the card: its batched
    distances through the kernels equal the plain twins' bit for bit and
    lie within 1e-4 of the float64 host query."""
    import contextlib
    import importlib.util
    import io

    from repro_torch.core import query, query_batch

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    out_text = io.StringIO()
    with contextlib.redirect_stdout(out_text):
        out = mod.main(device="cuda")
    seconds = time.perf_counter() - t0
    by_path["quickstart"] = {n: k.launches for n, k in kernels.items()}
    for line in out_text.getvalue().splitlines():
        print(f"quickstart:   {line}")
    qs = out["queries"]
    plain = query_batch(out["packed"], qs.s.astype(np.float32),
                        qs.t.astype(np.float32)).cpu().numpy()
    require(np.array_equal(out["d"], plain),
            "quickstart: use_kernels=True != use_kernels=False")
    truth = np.array([query(out["index"], a, b, want_path=False)[0]
                      for a, b in zip(qs.s, qs.t)])
    rel = near_oracle(out["d"], truth)
    require(by_path["quickstart"]["segvis"] > 0
            and by_path["quickstart"]["label_join_rowmin"] > 0,
            f"the quickstart launched {by_path['quickstart']}")
    print(f"quickstart: {len(truth)} batched distances on the card == the "
          f"plain twins' bit for bit, max rel err vs the host query "
          f"{rel:.3e}; launches {by_path['quickstart']}; host "
          f"{seconds:.3f} s")


def run_main(argv) -> tuple:
    """(final loss, printed lines) of one in-process run of the port's
    training launcher."""
    import contextlib
    import io

    from repro_torch.launch.train import main as train_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        loss = train_main(argv)
    return loss, out.getvalue().splitlines()


def step_losses(lines) -> list:
    return [float(x.split("loss=")[1].split()[0]) for x in lines
            if x.startswith("step")]


def lm_train_families(dev, kernels: dict, by_path: dict) -> None:
    """The ten reduced configs' training on the card: loss and every
    gradient leaf == the CPU's on the same f32 parameters (the CPU parity
    tests' tolerances), then the launcher (``launch.train.main`` with
    ``--device cuda``) for every token-only family (whisper takes encoder
    frames, which the launcher's data pipeline does not make, as in the
    reference), then tinyllama reduced: 16 guarded steps with a fault
    injected at step 6 and checkpoints every 4 under ``build/``, a
    ``--resume`` run from the last checkpoint, and ``--grad-compress`` on
    one rank."""
    import shutil

    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import transformer as T
    from repro_torch.tree import flatten

    full_f32_matmuls()
    label = "LM families train"
    print(f"path: {label}, reduced")
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = T.init_params(cfg, LM_SEED, dtype=torch.float32,
                               device="cpu")
        rng = np.random.default_rng(LM_SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)).astype(
            np.int32))
        enc = (torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))
            if cfg.encdec else None)
        want_loss, want = loss_and_grads(cfg, params, toks, enc)
        got_loss, got = loss_and_grads(
            cfg, T.to_device(params, dev), toks.to(dev),
            None if enc is None else enc.to(dev))
        atol = LM_FAMILY_ATOL.get(arch, 1e-5)
        require(lm_close(got_loss.cpu(), want_loss, 1e-4, atol),
                f"{arch} reduced: card loss {float(got_loss)} != CPU "
                f"{float(want_loss)}")
        worst = tree_errors(flatten(got), flatten(want), 1e-4, atol, 1.0)
        print(f"check: {arch} reduced train card == CPU: loss "
              f"{float(want_loss):.4f} (|error| "
              f"{abs(float(got_loss) - float(want_loss)):.3e}); gradients "
              f"within rtol 1e-4, atol {atol:g} x max(1, |leaf|): largest "
              f"|error| / scale {worst:.3e}")
    ckpt = ROOT / "build" / "chip_smoke_train"
    base = ["--reduced", "--batch", "4", "--seq", "64", "--device", "cuda"]
    for arch in ARCH_IDS:
        if get_config(arch).encdec:
            continue
        shutil.rmtree(ckpt, ignore_errors=True)
        _, lines = run_main(["--arch", arch, "--steps", "6", "--ckpt-dir",
                             str(ckpt)] + base)
        losses = step_losses(lines)
        require(len(losses) == 6 and all(np.isfinite(losses)),
                f"{arch} reduced: launcher losses {losses}")
        print(f"train: {arch} reduced, launcher on the card, 6 steps: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    shutil.rmtree(ckpt, ignore_errors=True)
    arch = ["--arch", LM_ARCH, "--ckpt-dir", str(ckpt), "--lr", "3e-3"] + base
    _, lines = run_main(arch + ["--steps", "16", "--ckpt-every", "4",
                                "--fault-inject", "6"])
    losses = step_losses(lines)
    restored = [x.strip() for x in lines if "[guard] restored step" in x]
    require(len(losses) == 16 and losses[-1] < losses[0]
            and restored == ["[guard] restored step 4"],
            f"guarded run: losses {losses}, guard lines {restored}")
    print(f"train: {LM_ARCH} reduced, 16 guarded steps with a fault at step 6"
          f": {restored[0]}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    _, lines = run_main(arch + ["--steps", "20", "--resume"])
    resumed = [x for x in lines if x.startswith("resumed from step")]
    losses = step_losses(lines)
    require(resumed == ["resumed from step 15"] and len(losses) == 5,
            f"resume: {resumed}, {len(losses)} steps")
    print(f"train: {LM_ARCH} reduced --resume: {resumed[0]}, steps 15-19, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    shutil.rmtree(ckpt, ignore_errors=True)
    _, lines = run_main(arch + ["--steps", "10", "--grad-compress"])
    losses = step_losses(lines)
    require(len(losses) == 10 and losses[-1] < losses[0],
            f"--grad-compress losses {losses}")
    print(f"train: {LM_ARCH} reduced --grad-compress (one rank): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    print(f"lm: {label}: {time.perf_counter() - t0:.2f} s")
    lm_kernel_launches(kernels, label, by_path)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    from repro_torch.core import (build_ehl, build_visgraph,
                                  compress_to_fraction, make_map,
                                  pack_bucketed, uniform_queries)
    from repro_torch.core.edgegrid import gather_edge_tiles
    from repro_torch.kernels import build, ops, ref
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
    lint_phase()

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
    # the label_join entry: the row join, then torch.amin over the row
    ops.label_join_kernel.launches = 0
    entry_err = 0.0
    for L in bx.widths:
        for what, (hs, vs, ht, vt) in (("synthetic", join_args[L]),
                                       ("main-path", main_ops[L][3])):
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                args = (hs, vs.to(dt), ht, vt.to(dt))
                got = ops.label_join_kernel(*args)
                want = ref.label_join_ref(*args)
                torch.cuda.synchronize()
                require(got.dtype == torch.float32 and torch.equal(got, want),
                        f"label_join != label_join_ref at {dt}, {what} "
                        f"B={B}, L={L}")
                entry_err = max(entry_err, max_abs_err(got, want))
    entry_checks = ops.label_join_kernel.launches
    print(f"check: label_join (row join + amin) == label_join_ref at B = "
          f"{B}, L in {bx.widths}, float32, bf16 and f16 distances, "
          f"synthetic and main-path rows ({entry_checks} launches)")
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
    # label_join (the row join + amin entry) is on no serving path, as in
    # the reference: every path reads its count, which stays 0
    kernels = {"segvis": segvis, "label_join_rowmin": label_join_rowmin,
               "segvis_tiles": segvis_tiles,
               "label_join": ops.label_join_kernel}
    by_path = {}
    print(f"path: {MAP} dense (default policy)")
    srv = PathServer(CudaEngine(bx), batch_size=B)
    # the warmed engines the ``syncs:`` phase stages one batch through, by
    # path label (each path adds its own; a PathServer stands for its
    # replicas)
    staged = {f"{MAP} dense": srv.engine}
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

    # -- 6a. serving telemetry and attribution on the dense path -------------
    telemetry_path(bx, index, dense_got, s, t, kernels, twins, by_path)

    # -- 6b. the single slab, f32 path and bf16 answers -----------------------
    slab_path(index, bx, dense_got, s, t, qs, kernels, twins, dev, by_path,
              staged)

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
                   by_path, staged)

    # -- 10. a device-budgeted bf16 artifact ----------------------------------
    budgeted_artifact(scene, graph, bx, s, t, qs, dev)

    # -- 10b. the adaptive index lifecycle: capture, replan, hot swap ---------
    adaptive_path(scene, graph, index, kernels, twins, dev, by_path)

    # -- 10c. region sharding: four shards on the card, then the reference's
    # sharded acceptance configuration with a swap under load -------------
    sharded_path(index, bx, sh, gsh, dense_got, s, t, qs, kernels, twins,
                 dev, by_path, staged)
    sharded_acceptance(kernels, twins, dev, by_path)

    # -- 10c'. data-parallel EHL: each batch in row blocks over a mesh -------
    batch_sharded_path(bx, index, dense_got, s, t, qs, kernels, twins, dev,
                       by_path, staged)

    # -- 10c''. the syncs the card reports on the staged path, held against
    # the lint's markers; then the quickstart on the card -------------------
    syncs_phase(staged, s, t, kernels, by_path)
    quickstart_phase(kernels, by_path)

    # -- 10d. the LM port: tinyllama-1.1b at full width, then the ten
    # architectures reduced (plain PyTorch: no EHL kernel launches) --------
    lm_full_width(dev, kernels, by_path)
    lm_families(dev, kernels, by_path)

    # -- 10e. LM training: tinyllama-1.1b at full width, then the reduced
    # families through the launcher (plain PyTorch: no EHL kernel launches)
    lm_train_full_width(dev, kernels, by_path)
    lm_train_families(dev, kernels, by_path)

    # -- 10f. the distributed half on one card: a one-rank NCCL mesh ---------
    lm_mesh_train(dev, kernels, by_path)
    flash_decode_path(dev, kernels, by_path)
    moe_ep_path(dev, kernels, by_path)
    pipeline_path(dev, kernels, by_path)
    dryrun_cells()
    if torch.cuda.device_count() < 2:
        print(f"multi-gpu: this machine has {torch.cuda.device_count()} "
              "CUDA device; no multi-rank NCCL run was possible here (the "
              "multi-rank paths ran on one rank)")

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
        cost = kernel_cost("segvis", (n, E))     # all pairs; p, q, edges in
        nbytes = cost["bytes"]
        need = pairs_needed(args)
        b_ms, by = bound(nbytes, SEGVIS_OPS_PER_PAIR * need)
        all_ms, _ = bound(nbytes, cost["ops"])
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
        cost = kernel_cost("label_join_rowmin", (Bj, L),
                           args[1].element_size())
        nbytes = cost["bytes"]
        b_ms, by = bound(nbytes, cost["ops"])
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

    # the label_join entry (row join + torch.amin) on the main path's rows
    # at the widest width: all device ops of one call, beside the twin
    entry_rows = []
    for w in sorted(main_ops):
        args = main_ops[w][3]
        ms = sum(us for _, us in device_ms(
            lambda: ops.label_join_kernel(*args), 50).values()) / 50 / 1e3
        plain = sum(us for _, us in device_ms(
            lambda: ref.label_join_ref(*args), 5).values()) / 5 / 1e3
        cost = kernel_cost("label_join", tuple(args[0].shape))
        b_ms, by = bound(cost["bytes"], cost["ops"])
        entry_rows.append((w, ms, plain, b_ms, by))
        print(f"time: label_join (entry) main-path B={B} L={w}: kernels "
              f"{ms:.5f} ms (row join + amin), twin {plain:.5f} ms, bound "
              f"{b_ms:.5f} ms ({by}: {cost['bytes']} bytes, the [B] minima "
              f"out)")

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
        cost = kernel_cost("segvis_tiles", (n, S))   # all slots
        b_ms, by = bound(cost["bytes"] - TILE_BYTES_PER_SLOT * (n * S - need),
                         TILE_OPS_PER_SLOT * need)
        full_ms, _ = bound(cost["bytes"], cost["ops"])
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
        # no engine path calls the label_join entry (as in the reference):
        # its main-path launches are 0, its launches in this script's
        # checks are beside them
        {"name": "label_join", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/label_join.cu + torch.amin "
                   "(src/repro_torch/kernels/ops.py label_join_kernel)",
         "replaces": "src/repro/kernels/label_join.py:92",
         "launches": totals["label_join"],
         "launches_by_path": {p: run["label_join"]
                              for p, run in by_path.items()},
         "launches_in_checks": entry_checks,
         "max_abs_err": entry_err, "ms": entry_rows[-1][1],
         "plain_ms": entry_rows[-1][2], "bound_ms": entry_rows[-1][3],
         "bound_by": entry_rows[-1][4], "library_ms": None,
         "shape": f"main-path B={B},L={entry_rows[-1][0]}"},
    ]}))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
