"""Adaptive index lifecycle — traffic in, re-optimized artifact out.

:class:`IndexManager` owns the closed loop the rest of the subsystem plugs
into:

1. **capture** — ``PathServer`` (and its continuous batcher) feeds every
   answered query into the manager's
   :class:`~repro_torch.indexing.recorder.WorkloadRecorder`;
2. **plan** — :meth:`maybe_adapt` asks the
   :class:`~repro_torch.indexing.planner.BudgetPlanner` whether the recorded
   distribution / budget warrants recompression (incremental resume or
   replan-from-snapshot, see planner docs);
3. **build** — the host-side merge loop + repack run *off* the serving path
   (inline or on a background thread), aliasing the device-resident edge
   tensors (``pack_bucketed(reuse_edges_from=...)``) and reusing the
   per-region pack caches;
4. **validate** — the candidate artifact answers a fixed probe query set
   and must match the live artifact (compression preserves optimality, so
   any disagreement beyond float tolerance aborts the swap);
5. **swap** — the candidate is warmed at the serving batch shape (its
   kernels loaded, its shapes and staging slots seen), then
   :class:`~repro_torch.indexing.swap.SwappableEngine` publishes it
   atomically; in-flight requests drain on the old artifact before its
   device buffers drop.

The budget is a device-byte budget on the packed artifact — what serving
actually allocates — and is enforced on every candidate before it goes live.

Device work of an attempt (probe validation and the candidate's warmup)
runs on the artifact's own device and that device's default stream, the
stream the serving paths compute on, whether the attempt runs inline or on
the background thread.

Region sharding (``num_shards > 1``): the budget stays a *total* device
budget; each shard replicates the full-grid mapper and carries its clipped
edge tensors, so the compressible slab budget shrinks by that overhead
(``sharded_overhead_bytes``), every candidate is also held to a per-shard
cap, and ``SwappableEngine.swap`` of a ``ShardedQueryEngine`` flips every
shard under one generation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compression import compress_to_device_budget
from repro_torch.core.geometry import random_free_points
from repro_torch.core.grid import EHLIndex
from repro_torch.core.packed import (LAYOUT_F32, bucketed_device_bytes,
                                     pack_bucketed, resolve_device,
                                     slab_layout)
from repro_torch.launch.mesh import shard_devices
from repro_torch.obs.locks import make_lock
from repro_torch.serving.query_engine import make_engine
from repro_torch.sharding import (ShardedQueryEngine, ShardPlanner,
                                  sharded_overhead_bytes)

from .planner import BudgetPlanner, PlanDecision
from .recorder import WorkloadRecorder
from .swap import SwappableEngine


def engine_answers(engine, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Route a batch through any ``QueryEngine`` with exact shapes.

    Engines with a full-pipeline ``query`` use it; otherwise the batch is
    grouped by ``buckets_of`` and dispatched per routing key — the same
    calls ``query_batch_bucketed`` makes for a device engine, so probe
    validation stays bitwise-comparable across engine kinds and
    generations.
    """
    fn = getattr(engine, "query", None)
    if fn is not None:
        return np.asarray(fn(s, t))
    keys = engine.buckets_of(s, t)
    out = np.empty(len(s), np.float32)
    for k in np.unique(keys):
        m = keys == k
        out[m] = np.asarray(engine.batch(s[m], t[m], bucket=int(k)))
    return out


@dataclasses.dataclass
class SwapRecord:
    """One adaptation attempt (successful swap or aborted candidate)."""
    generation: int         # generation the attempt produced (or would have)
    kind: str               # planner decision kind
    drift: float
    reason: str
    merges: int
    regions: int
    label_bytes: int
    device_bytes: int
    build_s: float          # recompression (host merge loop)
    pack_s: float           # repack + engine warmup
    validate_s: float
    probe_max_err: float
    swapped: bool
    abort_reason: str = ""  # non-empty iff the candidate was rejected


class IndexManager:
    """Budgeted, self-adapting index behind a hot-swappable engine.

    ``index``: the freshly built (uncompressed) host ``EHLIndex`` — the
    manager snapshots its singleton region set as the replan base, performs
    the initial budget fit with uniform scores, and packs the first serving
    artifact.  Wire ``manager.engine`` and ``manager.recorder`` into a
    ``PathServer`` and call :meth:`maybe_adapt` between serving rounds (or
    with ``block=False`` to build/validate/swap on a background thread).

    ``backend``: ``cuda`` (the Hopper kernels; their plain twins on CPU
    tensors) or ``torch`` (the twins).  ``device``: where every generation's
    artifact lives; ``cuda`` raises without a card.  ``num_shards > 1``
    serves a region-sharded artifact (``repro_torch.sharding``) on
    ``shard_devices(mesh, num_shards, device)``, each shard held to
    ``shard_tol`` times its fair share of the budget.
    """

    def __init__(self, index: EHLIndex, device_budget_bytes: int,
                 backend: str = "cuda", lane: int = 128, alpha: float = 0.2,
                 batch_size: int = 256, probe=None, probe_n: int = 64,
                 validate_tol: float = 1e-4, min_queries: int = 256,
                 replan_threshold: float = 0.15,
                 exit_threshold: float | None = None, min_dwell: int = 2,
                 halflife: float = 4000.0, warm_argmin: bool = False,
                 num_shards: int = 0, mesh=None, shard_tol: float = 1.15,
                 seed: int = 0, layout=None, telemetry=None,
                 device="cuda"):
        if backend not in ("torch", "cuda"):
            raise ValueError("IndexManager serves packed artifacts; "
                             f"backend must be torch|cuda, got {backend!r}")
        self.device = resolve_device(device)
        self.host_index = index
        self._base = index.snapshot_regions()
        # lifecycle event sink (DESIGN.md §12): drift decisions, swaps /
        # aborts and quantization loud-fallbacks all land here.  Share one
        # Telemetry with the PathServer so serving + indexing events
        # interleave in a single JSONL stream.
        self.telemetry = obs.Telemetry() if telemetry is None else telemetry
        self.backend = backend
        self.lane = lane
        self.batch_size = batch_size
        self.validate_tol = float(validate_tol)
        self.warm_argmin = warm_argmin
        # slab layout ("f32" | "bf16" | "f16" | SlabLayout): quantized
        # layouts shrink the per-slot cost, so the same device budget admits
        # a finer region partition — every candidate of this manager's
        # lifetime packs (and is budget-measured) under this layout
        if isinstance(layout, str):
            layout = slab_layout(layout)
        self.layout = layout if layout is not None else LAYOUT_F32
        # sharded serving (repro_torch.sharding): the budget stays a *total*
        # device-byte budget; each shard replicates the mapper and carries
        # its clipped edges, so the compressible slab budget shrinks by that
        # overhead and candidates are also held to a per-shard cap
        self.num_shards = int(num_shards)
        self.mesh = mesh
        self.shard_tol = float(shard_tol)
        self._shard_planner = None
        self._shard_devices = None
        overhead = 0
        if self.num_shards > 1:
            self._shard_planner = ShardPlanner(self.num_shards, lane=lane,
                                               tol=shard_tol,
                                               layout=self.layout)
            self._shard_devices = shard_devices(mesh, self.num_shards,
                                                device=self.device)
            overhead = sharded_overhead_bytes(index, self.num_shards, lane,
                                              layout=self.layout)
            if overhead >= device_budget_bytes:
                raise ValueError(
                    f"device budget {device_budget_bytes}B is infeasible "
                    f"for {self.num_shards} shards: replicated mapper + "
                    f"edge tensors alone cost {overhead}B")
        self._shard_overhead = overhead
        slab_budget = device_budget_bytes - overhead
        self.recorder = WorkloadRecorder.for_index(index, halflife=halflife)
        self.planner = BudgetPlanner(slab_budget, alpha=alpha,
                                     min_queries=min_queries,
                                     replan_threshold=replan_threshold,
                                     exit_threshold=exit_threshold,
                                     min_dwell=min_dwell, lane=lane,
                                     layout=self.layout)
        # planner decision/execution records join the same structured
        # event stream as swaps and drift (DESIGN.md §13)
        self.planner.events = self.telemetry.events
        # initial fit: uniform scores (no traffic observed yet)
        if bucketed_device_bytes(index, lane,
                                 layout=self.layout) > slab_budget:
            compress_to_device_budget(index, slab_budget, lane=lane,
                                      layout=self.layout)
        art0 = self._pack()
        if art0.device_bytes() > device_budget_bytes:
            raise ValueError(
                f"device budget {device_budget_bytes}B is infeasible: after "
                f"budget-driven merging the artifact still needs "
                f"{art0.device_bytes()}B (mapper + edge tensors are a fixed "
                "floor no amount of merging removes)")
        self.engine = SwappableEngine(self._make_engine(art0))
        if probe is not None:
            self._probe_s = np.asarray(probe[0], np.float32)
            self._probe_t = np.asarray(probe[1], np.float32)
        else:
            rng = np.random.default_rng(seed)
            pts = random_free_points(index.scene, 2 * probe_n, rng)
            self._probe_s = pts[:probe_n].astype(np.float32)
            self._probe_t = pts[probe_n:].astype(np.float32)
        self.history: list[SwapRecord] = []
        self.validation_failures = 0
        self._thread: threading.Thread | None = None
        self._adapt_lock = make_lock("indexing.adapt")

    # ------------------------------------------------------------- queries
    @property
    def generation(self) -> int:
        return self.engine.generation

    @property
    def swaps(self) -> int:
        return self.engine.swaps

    def device_bytes(self) -> int:
        return self.engine.device_bytes()

    def device_budget_bytes(self) -> int:
        """Total budget (slab budget + per-shard replication overhead)."""
        return self.planner.device_budget_bytes + self._shard_overhead

    def set_budget(self, device_budget_bytes: int) -> None:
        self.planner.set_budget(device_budget_bytes - self._shard_overhead)

    def probe_set(self) -> tuple[np.ndarray, np.ndarray]:
        """The fixed probe queries swap validation runs against."""
        return self._probe_s, self._probe_t

    def probe_answers(self) -> np.ndarray:
        """Current live engine's answers on the probe set."""
        with self._on_device():
            return engine_answers(self.engine.current,
                                  self._probe_s, self._probe_t)

    # ------------------------------------------------------------- packing
    def _on_device(self):
        """Context of an attempt's device work: the artifact's device and
        its default stream (the serving paths' compute stream), explicit,
        since a background thread starts on the current device's."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(
            torch.cuda.default_stream(self.device)))
        return stack

    def _pack(self, reuse_from=None):
        """Freeze host_index into the serving artifact on the device(s)
        (sharded or not)."""
        if self._shard_planner is not None:
            return self._shard_planner.build(self.host_index,
                                             reuse_edges_from=reuse_from,
                                             device=self._shard_devices)
        return pack_bucketed(self.host_index, lane=self.lane,
                             reuse_edges_from=reuse_from, layout=self.layout,
                             device=self.device)

    @staticmethod
    def _qerr_of(artifact) -> float:
        """Worst-case per-label quantization error of a packed artifact."""
        shards = getattr(artifact, "shards", None) or (artifact,)
        return max(float(bx.qerr) if bx.qerr is not None else 0.0
                   for bx in shards)

    def _make_engine(self, artifact):
        if self._shard_planner is not None:
            eng = ShardedQueryEngine(artifact, backend=self.backend)
            eng.bind_telemetry(self.telemetry)
            return eng
        return make_engine(artifact, backend=self.backend,
                           device=self.device)

    def _emit_quant_fallbacks(self, artifact, generation: int) -> None:
        """Loud-fallback events: any bucket whose slab could not take the
        quantized encoding (and silently pays f32/i32 widths) is a
        capacity/accuracy signal the operator should see."""
        if not self.layout.quantized:
            return
        for shard, bx in enumerate(getattr(artifact, "shards", None)
                                   or (artifact,)):
            qs = bx.quant_stats()
            falls = {k: [i for i, f in enumerate(qs.get(k, ())) if f]
                     for k in ("id_fallback", "vid_fallback",
                               "dist_fallback")}
            falls = {k: v for k, v in falls.items() if v}
            if falls:
                self.telemetry.events.emit(
                    "quant_fallback", generation=generation, shard=shard,
                    qerr=qs["qerr"], **falls)

    # ------------------------------------------------------------ adaptation
    def maybe_adapt(self, block: bool = True) -> bool:
        """One adaptation step; True iff a swap was published (blocking mode).

        ``block=False`` runs build/validate/swap on a background thread and
        returns immediately (False); poll :attr:`swaps` / call :meth:`join`.
        A build already in flight makes this a no-op.
        """
        if self._thread is not None and self._thread.is_alive():
            return False
        # one stopwatch carries the whole attempt (DESIGN.md §13): every
        # stage boundary is a lap() on it, so the BUILD_STAGES spans
        # telescope to end-to-end exactly — including the thread handoff
        # of an async build, which lands inside the "compress" lap
        sw = obs.Stopwatch()
        decision = self.planner.decide(self.recorder, self.host_index)
        plan_s = sw.lap()
        if decision.kind == "skip":
            return False
        trace = obs.Trace(kind="build", decision=decision.kind,
                          drift=decision.drift,
                          async_build=not block)
        trace.stage("plan", plan_s)
        self.telemetry.events.emit("drift", decision=decision.kind,
                                   drift=decision.drift,
                                   reason=decision.reason,
                                   recorded_queries=self.recorder.queries)
        if block:
            return self._adapt(decision, trace, sw)
        self._thread = threading.Thread(target=self._adapt,
                                        args=(decision, trace, sw),
                                        name="index-manager-adapt",
                                        daemon=True)
        self._thread.start()
        return False

    def join(self, timeout: float | None = None) -> None:
        """Wait for a background adaptation to finish."""
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def building(self) -> bool:
        """True while a background adaptation runs."""
        return self._thread is not None and self._thread.is_alive()

    def _close_build_trace(self, trace, sw, outcome: str) -> None:
        """Publish one attempt's span tree + per-stage histograms."""
        # sw.t0 is the timestamp of the last lap, so stage_sum == e2e
        # bit-for-bit; the stopwatch's construction time is the root start
        trace.close(trace.attrs.pop("t_start"), sw.t0, outcome)
        reg = self.telemetry.registry
        for name, seconds in trace.stages.items():
            reg.histogram("build_stage_ms", stage=name).record(seconds * 1e3)
        reg.counter("builds_total", outcome=outcome).inc()
        if self.telemetry.enabled:
            self.telemetry.spans.add(trace)

    def _adapt(self, decision: PlanDecision, trace=None, sw=None) -> bool:
        if sw is None:                  # direct call (tests): self-rooted
            sw = obs.Stopwatch()
            trace = obs.Trace(kind="build", decision=decision.kind,
                              drift=decision.drift, async_build=False)
            trace.stage("plan", 0.0)
        trace.attrs["t_start"] = sw.t0 - sum(trace.stages.values())
        with self._adapt_lock, self._on_device():    # one rebuild at a time
            # pre-adapt snapshot: an aborted candidate must not leave
            # host_index (the unwinding mirror of the live artifact) or the
            # planner baseline describing an index that never went live
            pre = self.host_index.snapshot_regions()
            trace.attrs["device_bytes_in"] = self.engine.device_bytes()
            stats = self.planner.execute(decision, self.host_index,
                                         self.recorder, self._base)
            build_s = sw.lap()
            trace.stage("compress", build_s)

            # the live artifact's placed edge tensors are aliased (a sharded
            # artifact's shards already live on their devices; its stored
            # edge masks gate the reuse shard by shard)
            bx = self._pack(reuse_from=self.engine.artifact)
            candidate = self._make_engine(bx)
            repack_s = sw.lap()
            trace.stage("repack", repack_s)

            d_live = engine_answers(self.engine.current,
                                    self._probe_s, self._probe_t)
            d_cand = engine_answers(candidate, self._probe_s, self._probe_t)
            both_inf = ~np.isfinite(d_live) & ~np.isfinite(d_cand)
            # np.max, not nanmax: a NaN-vs-finite disagreement must
            # propagate into max_err and abort, not be skipped over
            err = np.abs(np.where(both_inf, 0.0, d_cand - d_live))
            max_err = float(np.max(err)) if err.size else 0.0
            # quantized layouts: each generation's reported distance sits
            # within 2*qerr of the exact answer (one bound per endpoint
            # side), so two exact-equal generations may still disagree by
            # the sum of their bounds — widen the tolerance accordingly
            tol = self.validate_tol
            if self.layout.quantized:
                tol += 2.0 * (self._qerr_of(self.engine.artifact)
                              + self._qerr_of(bx))
            ok = bool(np.isfinite(max_err)) and max_err <= tol
            abort = "" if ok else (f"probe mismatch {max_err:.3e} > "
                                   f"{tol:.1e}")
            # the documented guarantee: no over-budget candidate goes live
            budget = self.device_budget_bytes()
            if ok and bx.device_bytes() > budget:
                ok = False
                abort = (f"candidate {bx.device_bytes()}B over device "
                         f"budget {budget}B")
            if ok and self._shard_planner is not None:
                # per-device cap: no shard may exceed its fair share of the
                # total budget by more than the balance tolerance
                cap = self.shard_tol * budget / self.num_shards
                worst = max(bx.per_shard_bytes())
                if worst > cap:
                    ok = False
                    abort = (f"shard imbalance: max shard {worst}B over "
                             f"per-device cap {cap:.0f}B "
                             f"({self.shard_tol:.2f}x budget/"
                             f"{self.num_shards})")
            validate_s = sw.lap()
            trace.stage("validate", validate_s)

            stage_s = 0.0
            if ok:
                # warm the candidate off the serving path so the first
                # post-swap batch meets no kernel load, cold shape or
                # staging setup — only survivors pay it; an aborted
                # candidate is dropped cold
                candidate.warmup(self.batch_size,
                                 want_argmin=self.warm_argmin)
                stage_s = sw.lap()
            trace.stage("stage", stage_s)

            rec = SwapRecord(
                generation=self.engine.generation + 1, kind=decision.kind,
                drift=decision.drift, reason=decision.reason,
                merges=stats.merges, regions=stats.regions,
                label_bytes=stats.final_bytes,
                device_bytes=bx.device_bytes(), build_s=build_s,
                pack_s=repack_s + stage_s, validate_s=validate_s,
                probe_max_err=max_err, swapped=ok, abort_reason=abort)
            self.history.append(rec)
            self.telemetry.events.emit(
                "swap" if ok else "swap_abort",
                **{("decision" if f.name == "kind" else f.name):
                   getattr(rec, f.name)
                   for f in dataclasses.fields(rec)})
            trace.attrs.update(
                generation=rec.generation, merges=stats.merges,
                regions_out=stats.regions,
                regions_in=stats.regions + stats.merges,
                label_bytes=stats.final_bytes,
                device_bytes_out=bx.device_bytes())
            if not ok:
                self.validation_failures += 1
                self.planner.discard()
                self.host_index.restore_regions(pre)    # roll back mirror
                trace.stage("swap", sw.lap())
                self._close_build_trace(trace, sw, "abort")
                return False
            self._emit_quant_fallbacks(bx, rec.generation)
            # validation traffic must not leak into the live serving stats
            reset = getattr(candidate, "reset_serve_counters", None)
            if reset is not None:
                reset()
            self.engine.swap(candidate)
            self.planner.commit()
            trace.stage("swap", sw.lap())
            self._close_build_trace(trace, sw, "ok")
            return True

    def stats(self) -> dict:
        """Lifecycle summary for logs / benches."""
        out = dict(generation=self.generation, swaps=self.swaps,
                   drops=self.engine.drops,
                   retired_pending=len(self.engine.retired_generations()),
                   validation_failures=self.validation_failures,
                   recorded_queries=self.recorder.queries,
                   device_bytes=self.device_bytes(),
                   device_budget_bytes=self.device_budget_bytes(),
                   attempts=len(self.history))
        if self._shard_planner is not None:
            out.update(num_shards=self.num_shards,
                       per_shard_bytes=self.engine.per_shard_bytes(),
                       shard_imbalance=round(self.engine.imbalance(), 4))
        return out
