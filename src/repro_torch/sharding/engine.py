"""Sharded serving behind the standard ``QueryEngine`` protocol.

:class:`ShardedQueryEngine` fronts a :class:`~repro_torch.serving.
shard_router.ShardRouter` with the interface ``PathServer`` already speaks
— ``buckets_of`` returns composite (shard_s, shard_t, width) routing keys
instead of bucket ids, and ``batch``/``batch_argmin`` decode them — so the
whole serving stack (fixed-shape batching, per-bucket stats, pinning, the
continuous batcher, ``SwappableEngine`` hot-swap, the adaptive
``IndexManager``) runs unchanged over a region-sharded index.

Atomic multi-shard swap falls out of the object model: the engine *is* the
full shard set, so ``SwappableEngine.swap(new ShardedQueryEngine)`` flips
every shard under one generation — a pinned request keeps the entire old
shard set alive until it drains; no mixed-generation batch is expressible.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.grid import EHLIndex
from repro_torch.core.packed import LAYOUT_F32, empty_results, splice_rescue
from repro_torch.launch.mesh import shard_devices
from repro_torch.serving.query_engine import (STAGING_SLOTS, Pending,
                                              QueryEngine)
from repro_torch.serving.shard_router import ShardRouter

from .planner import ShardedIndex, ShardPlanner


class ShardStats:
    """Per-shard serving and occupancy counters (``ServeStats.per_shard``):
    plain counters, as the port's ``BucketStats`` are."""

    def __init__(self, shard: int, device: str, regions: int,
                 device_bytes: int, used_slots: int, total_slots: int):
        self.shard = shard
        self.device = device
        self.regions = regions
        self.device_bytes = device_bytes
        self.used_slots = used_slots    # label slots holding real labels
        self.total_slots = total_slots  # label slots allocated (slab area)
        self.batches = 0        # sub-batches joined here
        self.slots = 0          # query slots dispatched here (incl. padding)
        self.seconds = 0.0
        self.gathers_out = 0    # label rows gathered here for another shard
        # covis verdicts computed here for another shard's join
        # (distributed s->t visibility over clipped edges, §10)
        self.covis_assists = 0

    @property
    def occupancy(self) -> float:
        """Real labels / allocated slab slots (packing efficiency)."""
        return self.used_slots / max(1, self.total_slots)

    @property
    def us_per_slot(self) -> float:
        return 1e6 * self.seconds / max(1, self.slots)


def shard_imbalance(stats: list) -> float:
    """max/mean of per-shard device bytes across a ``ShardStats`` list."""
    b = np.array([s.device_bytes for s in stats], dtype=np.float64)
    return float(b.max() / max(1.0, b.mean()))


class ShardedQueryEngine(QueryEngine):
    """Region-sharded slabs over devices, one ``QueryEngine``.

    ``index``: a planned :class:`ShardedIndex` (its shards already live on
    their devices), or a host ``EHLIndex`` that is planned and packed here
    (``num_shards`` required) onto ``shard_devices(mesh, num_shards,
    device)``: one shard per mesh device, or without a mesh round-robin
    over the devices of ``device``'s type (every shard on ``cuda:0`` on a
    one-card machine; ``cuda`` raises without a card).  ``backend``:
    ``cuda`` (the Hopper kernels; their twins on CPU tensors) or ``torch``
    (the twins).  ``rescue_batches``/``rescue_rows``/``rescue_seconds``
    count a quantized artifact's argmin rescues, as ``DeviceEngine`` does.
    """

    name = "sharded"
    static_shapes = True

    def __init__(self, index, num_shards: int | None = None, mesh=None,
                 backend: str = "cuda", device="cuda", lane: int = 128,
                 tol: float = 1.15, reuse_edges_from=None,
                 layout=LAYOUT_F32):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r} "
                             "(expected torch | cuda)")
        if isinstance(index, EHLIndex):
            if not num_shards or num_shards < 1:
                raise ValueError("building from a host index needs "
                                 "num_shards >= 1")
            planner = ShardPlanner(num_shards, lane=lane, tol=tol,
                                   layout=layout)
            index = planner.build(
                index, reuse_edges_from=reuse_edges_from,
                device=shard_devices(mesh, num_shards, device=device))
        if not isinstance(index, ShardedIndex):
            raise TypeError(f"unsupported artifact: {type(index)!r}")
        if mesh is not None and \
                index.devices != shard_devices(mesh, index.num_shards):
            raise ValueError(f"the shards live on {index.devices}, not on "
                             f"the mesh {tuple(mesh)}")
        self.index = index
        self.use_kernels = backend == "cuda"
        self.router = ShardRouter(index, use_kernels=self.use_kernels)
        self.quantized = self.router.quantized
        self.rescue_batches = 0
        self.rescue_rows = 0
        self.rescue_seconds = 0.0
        self._telemetry = None      # bound by IndexManager
        self._stats = [
            ShardStats(shard=k, device=str(bx.device),
                       regions=bx.num_regions,
                       device_bytes=bx.device_bytes(),
                       used_slots=bx.label_slots()[0],
                       total_slots=bx.label_slots()[1])
            for k, bx in enumerate(index.shards)]

    def bind_telemetry(self, telemetry) -> None:
        """Attach an event sink (cross-shard covis-assist events)."""
        self._telemetry = telemetry

    # ------------------------------------------------- QueryEngine protocol
    @property
    def num_buckets(self) -> int:
        """Size of the composite key space (routing keys index into it)."""
        s = self.index.num_shards
        return s * s * len(self.index.width_classes)

    def buckets_of(self, s, t) -> np.ndarray:
        return self.router.route_keys(s, t)

    def bucket_width(self, bucket: int) -> int:
        """Join width of a routing key — the W^2 a query at this key pays."""
        return self.router.key_width(bucket)

    def _note_dispatch(self, staged, n: int) -> None:
        """Traffic counters for one dispatched group (no blocking)."""
        st = self._stats[staged.i]
        st.batches += 1
        st.slots += n
        if staged.j != staged.i:
            self._stats[staged.j].gathers_out += n
        assists = [k for k in staged.parts if k != staged.i]
        for k in assists:
            self._stats[k].covis_assists += n
        if assists and self._telemetry is not None:
            self._telemetry.events.emit("covis_assist", home=staged.i,
                                        helpers=assists, n=n)

    def _rescue(self, staged, res, amb: np.ndarray) -> tuple:
        """Splice the exact answers of the ambiguous rows into ``res``, so
        argmin winners match the f32 sharded engine bit for bit."""
        t0 = time.perf_counter()
        out = splice_rescue((*res[:5], amb), self.router.rescue(staged))
        self.rescue_seconds += time.perf_counter() - t0
        self.rescue_batches += 1
        self.rescue_rows += int(np.count_nonzero(amb))
        return out

    def _answer(self, staged, want_argmin: bool):
        """Fold and join a staged group; host results (a quantized argmin
        reads its ambiguity flag — the sanctioned sync — and rescues)."""
        self.router.fold(staged)
        res = self.router.join_staged(staged, want_argmin=want_argmin)
        if not want_argmin:
            return res.cpu().numpy()
        if self.quantized:
            amb = res[5].cpu().numpy()
            if amb.any():
                return self._rescue(staged, res, amb)
        return tuple(r.cpu().numpy() for r in res[:5])

    def _run(self, s, t, key: int, want_argmin: bool):
        t0 = time.perf_counter()
        staged = self.router.stage(s, t, int(key))
        res = self._answer(staged, want_argmin)
        self._stats[staged.i].seconds += time.perf_counter() - t0
        self._note_dispatch(staged, len(staged.s))
        return res

    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        return self._run(s, t, bucket, want_argmin=False)

    def batch_argmin(self, s, t, bucket: int = 0):
        return self._run(s, t, bucket, want_argmin=True)

    # ------------------------------------------------ split-phase (async)
    def stage(self, s, t, bucket: int = 0):
        """Route one padded group and start its copies onto every device it
        involves; on the card through a pinned slot and copy streams, so
        nothing here waits on a device.  Returns the staged group."""
        return self.router.stage(s, t, int(bucket),
                                 pinned=self.router.on_card)

    def dispatch_staged(self, staged, bucket: int = 0,
                        want_argmin: bool = False) -> Pending:
        """Launch a staged group without waiting for the device (CUDA).

        Each involved device's compute stream waits on the group's copy
        event, then the folds, the wire, the co-visibility verdicts and the
        join run, and the results are copied into the slot's pinned planes;
        the returned :class:`Pending` waits on that copy.  The one host
        synchronisation is a quantized argmin's ambiguity flag, read to
        decide the rescue.  Per-shard seconds land through
        :meth:`note_batch_seconds`."""
        slot = staged.slot
        if slot is None:
            if self.router.on_card:
                raise TypeError("a CUDA engine dispatches only what its "
                                "stage() staged")
            res = self._answer(staged, want_argmin)
            self._note_dispatch(staged, len(staged.s))
            return Pending(tuple(res) if want_argmin else (res,))
        home = self.router.devices[staged.i]
        try:
            self.router.await_copies(staged)
            self.router.fold(staged)
            res = self.router.join_staged(staged, want_argmin=want_argmin)
            with self.router.on(home):
                if not want_argmin:
                    res = (res,)
                elif self.quantized:
                    amb = res[5].cpu().numpy()      # the sanctioned sync
                    if amb.any():
                        slot.busy = False
                        out = self._rescue(staged, res, amb)
                        self._note_dispatch(staged, len(staged.s))
                        return Pending(out)
                    res = res[:5]
                for o, r in zip(slot.outs, res):
                    o.copy_(r, non_blocking=True)
                done = slot.event(slot.done, home)
                done.record(torch.cuda.default_stream(home))
        except BaseException:
            slot.busy = False
            raise
        self._note_dispatch(staged, len(staged.s))
        return Pending([o.numpy() for o in slot.outs[:len(res)]],
                       done=done, slot=slot)

    def note_batch_seconds(self, bucket: int, seconds: float) -> None:
        """Async-path latency attribution to the key's home shard."""
        i, _, _ = self.router.decode_key(int(bucket))
        self._stats[i].seconds += seconds

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        """Run every (shard, width) fold, covis, join, wire and rescue entry
        at the serving batch shape; on the card the split-phase path runs
        too, ``STAGING_SLOTS`` groups in flight from each home shard, so the
        first async group pays no pinned slot, copy stream or event."""
        self.router.warmup(batch_size, want_argmin=want_argmin)
        if not self.router.on_card:
            return
        traffic = [dict(vars(st)) for st in self._stats]
        z = np.zeros((batch_size, 2), np.float32)
        nw = len(self.index.width_classes)
        for k in range(self.index.num_shards):
            key = (k * self.index.num_shards + k) * nw
            for argmin in (False, True) if want_argmin else (False,):
                pending = [self.dispatch_staged(self.stage(z, z, key), key,
                                                argmin)
                           for _ in range(STAGING_SLOTS)]
                for p in pending:
                    p.wait()
        for st, before in zip(self._stats, traffic):  # warmup is no traffic
            vars(st).update(before)

    def device_bytes(self) -> int:
        """Total across the devices; ``per_shard_bytes`` has each one's."""
        return self.index.device_bytes()

    # --------------------------------------------------------- observability
    def per_shard_bytes(self) -> list:
        return self.index.per_shard_bytes()

    def shard_stats(self) -> list:
        return self._stats

    def reset_serve_counters(self) -> None:
        """Zero the traffic counters (occupancy/bytes stay — they describe
        the artifact).  The IndexManager calls this after probe validation
        so a freshly swapped-in engine reports only real serving traffic."""
        for st in self._stats:
            st.batches = 0
            st.slots = 0
            st.seconds = 0.0
            st.gathers_out = 0
            st.covis_assists = 0

    def imbalance(self) -> float:
        return shard_imbalance(self._stats)

    # ------------------------------------------------------------- serving
    def query(self, s, t, want_argmin: bool = False):
        """Route + dispatch + in-order merge for a whole batch (exact
        shapes, no padding) — the validation/test entry.  Same dispatch
        path as ``batch`` so per-shard stats record either way."""
        s = np.asarray(s, np.float32)
        t = np.asarray(t, np.float32)
        n = len(s)
        outs = empty_results(n, want_argmin)
        keys = self.buckets_of(s, t) if n else np.zeros(0, np.int32)
        for key in np.unique(keys):
            m = keys == key
            res = self._run(s[m], t[m], int(key), want_argmin)
            for o, r in zip(outs, res if want_argmin else (res,)):
                o[m] = r
        return tuple(outs) if want_argmin else outs[0]
