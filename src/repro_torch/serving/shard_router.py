"""(shard, bucket) batch routing over a region-sharded index.

The serving half of ``repro_torch.sharding`` (DESIGN.md §9): a
:class:`~repro_torch.sharding.planner.ShardedIndex` keeps each shard's
bucket slabs — and its *clipped* edge subset and edge grid (§10) — on its
own device; the router turns an incoming query batch into per-(shard-pair,
width) sub-batches and merges the answers back in input order.

Routing per query (host numpy on host inputs, O(1) per endpoint):

1. locate both endpoints' cells (the same float32 floor-divide as the
   device's ``locate_regions``, so cell ids agree bit for bit);
2. the routing table maps each cell to ``(shard, local region, bucket
   width)``;
3. the composite key ``(shard_s, shard_t, join width)`` groups the batch.

Per group, edges are clipped per shard, so each visibility term runs where
its covering edge subset lives:

* each endpoint side gathers its label rows *and folds in via visibility*
  on its owning device (``gather_masked_labels`` — the owner's clip covers
  every query-point -> via segment of regions it owns); for a cross-shard
  query the t-side ``(hub, vd, vid)`` triple moves to the s-side (home)
  device ([B, W] tensors — the slabs never move), or, on a quantized
  artifact, its encoded rows do (``gather_quant_rows`` →
  ``dequant_masked_labels``, ~7 instead of 12 bytes a slot);
* the direct s->t co-visibility segment can cross *any* shard's territory,
  so every shard whose owned bounding box meets the batch's bounding box
  answers against its local edges and the [B] verdicts are OR-merged on the
  home device;
* the join (``join_masked``) runs on the home device.

All three pieces are the single-device engine's own fold and join code, so
answers are bitwise-identical to the unsharded ``BucketedIndex`` engine.

The phases: :meth:`ShardRouter.stage` routes on the host and starts the
batch's host-to-device copies onto every device involved (on the card
through a pinned slot and a copy stream per device, with one CUDA event a
device, so staging never waits on a device); :meth:`ShardRouter.fold`
launches the gathers, folds, the wire and the co-visibility verdicts, and
:meth:`ShardRouter.join_staged` the join, each on its device's default
stream.  On a machine with one card every shard lives on ``cuda:0`` and
the cross-shard moves are same-device no-ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.packed import (TRACES, covis_blocked,
                                     dequant_masked_labels,
                                     gather_masked_exact,
                                     gather_masked_labels, gather_quant_rows,
                                     join_masked, locate_cells)


def _copy_unpinned(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: the unpinned staging of the synchronous
    ``batch``/``batch_argmin`` path and of CPU tensors."""
    return torch.from_numpy(x).to(dev)  # repolint: disable=hot-path-sync -- unpinned staging backs the synchronous path and CPU tensors; the card's split phase stages through pinned slots


class _ShardSlot:
    """One pinned staging slot of a routed batch: its endpoints and the
    local region ids of both sides going in, the five result planes coming
    out, and per device the event of its copies and of its results."""

    def __init__(self, rows: int):
        def pinned(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, pin_memory=True)

        self.s = pinned(rows, 2)
        self.t = pinned(rows, 2)
        self.loc_s = pinned(rows, dtype=torch.int32)
        self.loc_t = pinned(rows, dtype=torch.int32)
        self.outs = (pinned(rows), pinned(rows, dtype=torch.bool),
                     pinned(rows, dtype=torch.int32),
                     pinned(rows, dtype=torch.int32),
                     pinned(rows, dtype=torch.int32))
        self.copied: dict = {}      # device -> event of its H2D copies
        self.done: dict = {}        # home device -> event of the D2H copies
        self.busy = False           # staged, results not yet read

    @staticmethod
    def event(table: dict, dev: torch.device):
        if dev not in table:
            table[dev] = torch.cuda.Event()
        return table[dev]


@dataclasses.dataclass
class StagedGroup:
    """One routed sub-batch, staged: produced by :meth:`ShardRouter.stage`,
    filled by :meth:`ShardRouter.fold`, consumed by
    :meth:`ShardRouter.join_staged`."""
    key: int
    i: int                  # s-side (join/home) shard
    j: int                  # t-side shard
    parts: list             # covis participant shards
    s: np.ndarray           # the batch on the host (routing, the rescue)
    t: np.ndarray
    s_on: dict              # device -> [B, 2] s on that device
    t_on: dict
    loc_s: torch.Tensor     # [B] local region ids of s, on shard i's device
    loc_t: torch.Tensor     # [B] local region ids of t, on shard j's device
    slot: _ShardSlot | None = None
    masked_s: tuple | None = None   # visibility-folded (hub, vd, vid), home
    masked_t: tuple | None = None   # same for the t side, moved home
    covis: torch.Tensor | None = None   # merged co-visibility bits, home

    @property
    def s_dev(self) -> torch.Tensor:
        """The s side on the home device (where ``loc_s`` lives)."""
        return self.s_on[self.loc_s.device]

    @property
    def t_dev(self) -> torch.Tensor:
        """The t side on the home device."""
        return self.t_on[self.loc_s.device]


class ShardRouter:
    """Split batches by destination shard, dispatch, merge in input order.

    ``sharded``: a :class:`~repro_torch.sharding.planner.ShardedIndex`
    whose shards already live on their devices.  ``use_kernels``: the
    Hopper kernels (their twins on CPU tensors) or the plain twins.
    """

    def __init__(self, sharded, use_kernels: bool = False):
        self.sharded = sharded
        self.use_kernels = use_kernels
        self.num_shards = sharded.num_shards
        self.shards = list(sharded.shards)
        self.devices = [bx.device for bx in self.shards]
        self.on_card = self.devices[0].type == "cuda"
        self.quantized = bool(self.shards
                              and self.shards[0].layout.quantized)
        # the argmin ambiguity threshold join_staged hands the join, per
        # (home, t-side) shard pair: the float32 sum of the two sides'
        # quantization error bounds, made here so dispatch reads no value
        qerr = [float(bx.qerr) if bx.qerr is not None else 0.0
                for bx in self.shards]
        self._qerr2 = [[float(np.float32(a) + np.float32(b)) for b in qerr]
                       for a in qerr]
        self.width_classes = np.asarray(sharded.width_classes, np.int64)
        self._nw = len(self.width_classes)
        # per-shard clip bound: foreign/padding cells can carry local ids
        # from wider shards; clipping keeps the (discarded) gather in range
        self._rmax = np.array([max(0, bx.num_regions - 1)
                               for bx in self.shards], dtype=np.int32)
        # covis participation: slack-dilated owned rects (host side)
        self._rects = np.asarray(sharded.shard_rects, np.float64)
        self._covis_slack = 1e-3 * float(
            max(self.shards[0].width, self.shards[0].height))
        self._slots: dict[int, list[_ShardSlot]] = {}   # batch rows -> pool
        self._copy_streams: dict = {}                   # device -> stream
        # cross-shard traffic attribution: one stage-phase wall-time
        # histogram plus wire-row counters per (src, dst) pair
        self._obs_labels = {"router": obs.next_instance_id("r")}
        self._stage_ms = obs.REGISTRY.histogram("router_stage_ms",
                                                **self._obs_labels)

    # ------------------------------------------------------------- routing
    def _cells(self, pts: np.ndarray) -> np.ndarray:
        """Cell location (:func:`locate_cells`, ``locate_regions``'s bits)
        so host routing and device gathers agree."""
        sh = self.sharded
        return locate_cells(pts, sh.cell_size, sh.nx, sh.ny)

    def route_keys(self, s, t) -> np.ndarray:
        """[B] composite routing keys ``(shard_s, shard_t, width-class)``."""
        cs, ct = self._cells(s), self._cells(t)
        sh_s = self.sharded.cell_shard[cs].astype(np.int64)
        sh_t = self.sharded.cell_shard[ct].astype(np.int64)
        w = np.maximum(self.sharded.cell_width[cs],
                       self.sharded.cell_width[ct])
        wc = np.searchsorted(self.width_classes, w)
        return ((sh_s * self.num_shards + sh_t) * self._nw + wc
                ).astype(np.int32)

    def decode_key(self, key: int) -> tuple:
        """key -> (shard_s, shard_t, join width)."""
        key = int(key)
        wc = key % self._nw
        pair = key // self._nw
        return (pair // self.num_shards, pair % self.num_shards,
                int(self.width_classes[wc]))

    def key_width(self, key: int) -> int:
        return int(self.width_classes[int(key) % self._nw])

    def covis_shards(self, s: np.ndarray, t: np.ndarray) -> list:
        """Shards whose owned rect meets the batch's bounding box.

        Any edge the direct s->t segments can cross sits in a cell one of
        these shards owns, hence inside that shard's clipped edge subset.

        Zero-pair rows — both endpoints exactly the origin — are the tail
        padding serving batches carry; they are left out of the bbox so
        padded batches don't drag every shard below/left of the batch into
        the covis test.  Safe even for a *real* (0,0)->(0,0) query: a
        degenerate segment can never fire a §5 rule, so its covis bit is
        correct under any participant set.
        """
        real = np.any(s != 0.0, axis=1) | np.any(t != 0.0, axis=1)
        if not real.any():
            return []
        pts = np.concatenate([s[real], t[real]], axis=0)
        lo = pts.min(axis=0) - self._covis_slack
        hi = pts.max(axis=0) + self._covis_slack
        r = self._rects
        hit = ((r[:, 0] <= hi[0]) & (r[:, 2] >= lo[0]) &
               (r[:, 1] <= hi[1]) & (r[:, 3] >= lo[1]))
        return [int(k) for k in np.nonzero(hit)[0]]

    # -------------------------------------------------------------- stage
    def on(self, dev: torch.device):
        """Context of a shard's device work: on the card, that device and
        its default stream (the serving paths' compute stream)."""
        if dev.type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(dev))
        stack.enter_context(torch.cuda.stream(torch.cuda.default_stream(dev)))
        return stack

    def _slot(self, rows: int) -> _ShardSlot:
        """A free pinned slot for a batch of ``rows``; a new one (a cold
        staging shape, counted in ``TRACES``) when every slot is busy."""
        pool = self._slots.setdefault(rows, [])
        for slot in pool:
            if not slot.busy:
                break
        else:
            TRACES.see("shard_stage", "cuda", rows, len(pool))
            slot = _ShardSlot(rows)
            pool.append(slot)
        for ev in slot.copied.values():
            # never rewrite a slot mid-copy
            # repolint: disable=hot-path-sync -- a free slot's group was retired (Pending.wait, or the rescue's flag read) after its devices' compute streams waited on this event, so it has completed and this returns at once; only a slot freed by a failed dispatch can wait here
            ev.synchronize()
        slot.busy = True
        return slot

    def _copy_stream(self, dev: torch.device):
        if dev not in self._copy_streams:
            self._copy_streams[dev] = torch.cuda.Stream(dev)
        return self._copy_streams[dev]

    def stage(self, s, t, key: int, pinned: bool = False) -> StagedGroup:
        """Route one sub-batch and put it on every device involved.

        Host work: cells, the local region ids of both sides (clipped to
        each shard's range) and the covis participants.  Then one copy of
        each batch side per involved device (home, owner, participants),
        shared by the gathers, the covis verdicts and the join.  With
        ``pinned`` (the card's split-phase path) the copies go through a
        pinned slot on each device's copy stream and record one event a
        device, and nothing here waits on a device; otherwise they are
        plain copies on the current stream.
        """
        t_stage0 = time.perf_counter()
        i, j, _ = self.decode_key(key)
        # repolint: disable=hot-path-sync -- normalizes host inputs before the H2D enqueue; nothing lives on device yet
        s = np.asarray(s, np.float32)
        t = np.asarray(t, np.float32)  # repolint: disable=hot-path-sync -- same host-input normalization as the line above
        cs, ct = self._cells(s), self._cells(t)
        loc_s = np.minimum(self.sharded.cell_local[cs], self._rmax[i])
        loc_t = np.minimum(self.sharded.cell_local[ct], self._rmax[j])
        parts = self.covis_shards(s, t) or [i]
        devs = list(dict.fromkeys(self.devices[k] for k in (i, j, *parts)))
        dev_i, dev_j = self.devices[i], self.devices[j]
        s_on, t_on = {}, {}
        slot = None
        if pinned:
            slot = self._slot(len(s))
            slot.s.numpy()[:] = s
            slot.t.numpy()[:] = t
            slot.loc_s.numpy()[:] = loc_s
            slot.loc_t.numpy()[:] = loc_t
            for dev in devs:
                stream = self._copy_stream(dev)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    s_on[dev] = slot.s.to(dev, non_blocking=True)
                    t_on[dev] = slot.t.to(dev, non_blocking=True)
                    if dev == dev_i:
                        gi = slot.loc_s.to(dev, non_blocking=True)
                    if dev == dev_j:
                        gj = slot.loc_t.to(dev, non_blocking=True)
                    slot.event(slot.copied, dev).record(stream)
        else:
            for dev in devs:
                s_on[dev] = _copy_unpinned(s, dev)
                t_on[dev] = _copy_unpinned(t, dev)
            gi = _copy_unpinned(loc_s.astype(np.int32), dev_i)
            gj = _copy_unpinned(loc_t.astype(np.int32), dev_j)
        self._stage_ms.record((time.perf_counter() - t_stage0) * 1e3)
        return StagedGroup(key=int(key), i=i, j=j, parts=parts, s=s, t=t,
                           s_on=s_on, t_on=t_on, loc_s=gi, loc_t=gj,
                           slot=slot)

    def await_copies(self, st: StagedGroup) -> None:
        """Make each involved device's compute stream wait for the staged
        copies, and keep the allocator from handing their memory out
        before that stream is done with them (they were made on a copy
        stream).  A no-op for unpinned staging."""
        if st.slot is None:
            return
        for dev, ev in st.slot.copied.items():
            if dev in st.s_on:
                torch.cuda.default_stream(dev).wait_event(ev)
        for x in (*st.s_on.values(), *st.t_on.values(), st.loc_s, st.loc_t):
            x.record_stream(torch.cuda.default_stream(x.device))

    # --------------------------------------------------------------- fold
    def _covis(self, st: StagedGroup):
        """Merged co-visibility bits on the home device.  The per-shard
        verdicts are all launched before the OR merge reads them, so
        participating devices compute in parallel."""
        home = self.devices[st.i]
        verdicts = []
        for k in st.parts:
            bx, dev = self.shards[k], self.devices[k]
            with self.on(dev):
                verdicts.append(covis_blocked(
                    st.s_on[dev], st.t_on[dev], bx.edges_a, bx.edges_b,
                    bx.edges_c, bx.grid, use_kernels=self.use_kernels))
        blocked = None
        with self.on(home):
            for bk in verdicts:
                bk = bk.to(home, non_blocking=True)
                blocked = bk if blocked is None else blocked | bk
            return blocked == 0

    def fold(self, st: StagedGroup) -> None:
        """Launch the pre-join work of a staged group: both sides' gather +
        visibility fold on their owning shards, the t side's move to the
        home device (encoded on a quantized artifact), and the merged
        co-visibility verdicts.  Fills ``masked_s``, ``masked_t`` and
        ``covis``; nothing here waits on a device."""
        i, j, W = self.decode_key(st.key)
        dev_i, dev_j = self.devices[i], self.devices[j]
        with self.on(dev_i):
            st.masked_s = gather_masked_labels(
                self.shards[i], st.loc_s, st.s_on[dev_i], W,
                use_kernels=self.use_kernels)
        if i != j and self.quantized:
            with self.on(dev_j):
                wire = gather_quant_rows(
                    self.shards[j], st.loc_t, st.t_on[dev_j], W,
                    use_kernels=self.use_kernels)
            with self.on(dev_i):
                wire = tuple(x.to(dev_i, non_blocking=True) for x in wire)
                st.masked_t = dequant_masked_labels(
                    *wire, st.t_on[dev_i], self.shards[i].vert_xy)
        else:
            with self.on(dev_j):
                masked_t = gather_masked_labels(
                    self.shards[j], st.loc_t, st.t_on[dev_j], W,
                    use_kernels=self.use_kernels)
            with self.on(dev_i):
                st.masked_t = tuple(x.to(dev_i, non_blocking=True)
                                    for x in masked_t)
        st.covis = self._covis(st)
        if i != j:
            # wire-row attribution: [B, W] t-side rows shipped j -> i
            obs.REGISTRY.counter(
                "router_wire_rows_total", src=j, dst=i,
                wire="quant" if self.quantized else "f32",
                **self._obs_labels).inc(len(st.s) * W)

    def join_staged(self, st: StagedGroup, want_argmin: bool = False):
        """The Eq. 1-3 join of a folded group on its home device.

        Returns device tensors the caller reads.  A quantized artifact with
        ``want_argmin`` returns the 6-tuple with the ambiguity bits; the
        engine rescues flagged rows via :meth:`rescue`."""
        dev_i = self.devices[st.i]
        with self.on(dev_i):
            qerr2 = None
            if want_argmin and self.quantized:
                qerr2 = torch.full((), self._qerr2[st.i][st.j],
                                   dtype=torch.float32, device=dev_i)
            return join_masked(
                st.masked_s, st.masked_t, st.s_on[dev_i], st.t_on[dev_i],
                st.covis, use_kernels=self.use_kernels,
                want_argmin=want_argmin, qerr2=qerr2)

    def rescue(self, st: StagedGroup):
        """Exact-argmin rescue of one staged group (full batch, spliced by
        the caller): re-gather both sides with the exact residual distance
        rows, re-join on the home device without quantization error — the
        result matches the f32 sharded engine bit for bit."""
        i, j, W = self.decode_key(st.key)
        dev_i, dev_j = self.devices[i], self.devices[j]
        ri = self.shards[i].residual
        rj = self.shards[j].residual
        # repolint: disable=hot-path-sync -- exact rescue is the sanctioned sync: correctness over overlap (DESIGN.md §11)
        ds = torch.from_numpy(ri.gather_d(ri.locate(st.s), W)).to(dev_i)
        dt = torch.from_numpy(rj.gather_d(rj.locate(st.t), W)).to(dev_j)  # repolint: disable=hot-path-sync -- part of the sanctioned rescue sync above
        with self.on(dev_i):
            ms = gather_masked_exact(self.shards[i], st.s_on[dev_i], ds, W,
                                     use_kernels=self.use_kernels)
        with self.on(dev_j):
            mt = gather_masked_exact(self.shards[j], st.t_on[dev_j], dt, W,
                                     use_kernels=self.use_kernels)
        with self.on(dev_i):
            mt = tuple(x.to(dev_i) for x in mt)
            return join_masked(ms, mt, st.s_on[dev_i], st.t_on[dev_i],
                               st.covis, use_kernels=self.use_kernels,
                               want_argmin=True)

    def dispatch(self, s, t, key: int, want_argmin: bool = False):
        """Answer one routed sub-batch on its destination shard's device.

        Every query in ``s``/``t`` must carry routing key ``key`` (padding
        rows are exempt — their answers are garbage the caller discards,
        exactly like per-bucket dispatch under-width padding).  Returns
        device tensors; ``(i, j, covis participants)`` ride along for the
        caller's stats.  ``stage`` + ``fold`` + ``join_staged`` is the
        same path cut for pipelining.
        """
        st = self.stage(s, t, key)
        self.fold(st)
        return self.join_staged(st, want_argmin=want_argmin), \
            (st.i, st.j, st.parts)

    # ------------------------------------------------------------- warmup
    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        """Run every (device, width) gather/fold, covis, join, wire and
        rescue entry at the serving batch shape, so live traffic meets no
        kernel build or load and no new shape."""
        for k, bx in enumerate(self.shards):
            dev = self.devices[k]
            with self.on(dev):
                zd = torch.zeros((batch_size, 2), dtype=torch.float32,
                                 device=dev)
                zr = torch.zeros((batch_size,), dtype=torch.int32,
                                 device=dev)
                cz = covis_blocked(zd, zd, bx.edges_a, bx.edges_b,
                                   bx.edges_c, bx.grid,
                                   use_kernels=self.use_kernels) == 0
                for W in self.width_classes:
                    W = int(W)
                    if W < bx.widths[0]:
                        continue    # no local bucket fits under this width
                    masked = gather_masked_labels(
                        bx, zr, zd, W, use_kernels=self.use_kernels)
                    join_masked(masked, masked, zd, zd, cz,
                                use_kernels=self.use_kernels)
                    if self.quantized:
                        # the cross-shard wire: owner-side encoded gather
                        # + home-side decode (the dtypes any home meets)
                        wire = gather_quant_rows(
                            bx, zr, zd, W, use_kernels=self.use_kernels)
                        dequant_masked_labels(*wire, zd, bx.vert_xy)
                    if want_argmin:
                        join_masked(masked, masked, zd, zd, cz,
                                    use_kernels=self.use_kernels,
                                    want_argmin=True)
                        if self.quantized:
                            # the join with the ambiguity bits, and the
                            # rescue's exact gather
                            join_masked(masked, masked, zd, zd, cz,
                                        use_kernels=self.use_kernels,
                                        want_argmin=True,
                                        qerr2=torch.zeros(
                                            (), dtype=torch.float32,
                                            device=dev))
                            d0 = torch.full((batch_size, W), float("inf"),
                                            dtype=torch.float32, device=dev)
                            gather_masked_exact(bx, zd, d0, W,
                                                use_kernels=self.use_kernels)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
