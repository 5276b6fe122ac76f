"""Pluggable query backends behind one ``QueryEngine`` interface.

The serving layer (``PathServer``) is backend-agnostic: it routes batches,
keeps stats and scatters results; *how* a batch is answered is an engine
(DESIGN.md §6).  Three interchangeable backends:

* :class:`HostEngine`  — the scalar float64 oracle (``core.query``); slow,
  exact, the reference everything else is validated against.
* :class:`TorchEngine` — the batched engine over a packed layout with the
  plain PyTorch twins of the kernels.
* :class:`CudaEngine`  — the same engine through the Hopper kernels
  (``kernels.ops``; on CPU tensors that dispatch runs the twins).

The device engines accept either packed layout: the single-slab
:class:`PackedIndex` (one bucket) or the width-bucketed
:class:`BucketedIndex` (``buckets_of`` exposes the routing key).  They share
the query core in ``core.packed`` and differ only in its ``use_kernels``
flag.  On a quantized artifact (DESIGN.md §11) ``batch_argmin`` rescues the
rows the join flags as ambiguous against the exact residual rows, so its
winners equal the f32 engine's bit for bit.

Besides the synchronous ``batch``/``batch_argmin``, every engine has the
split-phase pair the continuous batcher (``serving.batcher``) drives:
``stage`` starts a batch's host-to-device copies and ``dispatch_staged``
launches its work without waiting for the device, returning a
:class:`Pending` whose ``wait`` is the one synchronisation.  On a CUDA
artifact staging goes through pinned host buffers and a copy stream
(:class:`DeviceEngine`); everywhere else the pair passes through to the
synchronous calls.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.grid import EHLIndex
from repro_torch.core.packed import (LAYOUT_F32, TRACES, BucketedIndex,
                                     PackedIndex, device_endpoints,
                                     gather_masked_exact,
                                     join_masked, pack_bucketed, query_batch,
                                     query_batch_argmin,
                                     query_batch_at_bucket, rescue_exact,
                                     splice_rescue)
from repro_torch.core.query import query as host_query

#: pinned staging slots the warmup allocates per batch shape: the batcher's
#: default pipeline depth (2) plus one
STAGING_SLOTS = 3


class Pending:
    """Results of a dispatched batch, possibly still on their way from the
    device.  :meth:`wait` blocks until they are on the host and returns
    them as numpy arrays (1 without argmin, 5 with)."""

    def __init__(self, outs, done=None, slot=None):
        self._outs = outs
        self._done = done           # torch.cuda.Event, or None when ready
        self._slot = slot           # staging slot released by wait()

    def wait(self) -> tuple:
        if self._done is not None:
            self._done.synchronize()
        outs = tuple(np.array(o) for o in self._outs)   # copies: pinned
        if self._slot is not None:                      # buffers are reused
            self._slot.busy = False
            self._slot = None
        return outs


class QueryEngine(abc.ABC):
    """Answer batches of ESPP queries; optionally bucket-routable.

    ``bucket`` arguments index the engine's dispatch buckets; engines with a
    single bucket (host oracle, single slab) ignore them.  ``batch`` returns
    [B] float32 distances; ``batch_argmin`` also returns the winning
    (covis, via_s, hub, via_t) ids for host-side path unwinding.  Both
    return numpy.
    """

    name: str = "abstract"
    static_shapes = False   # True: batches are padded to a fixed size
    generation = 0          # bumped by hot-swapping engines

    @contextlib.contextmanager
    def pin(self):
        """Pin a consistent engine for a multi-call request.

        ``PathServer`` routes one request through several engine calls
        (``buckets_of`` + one batch per bucket group); under a hot-swapping
        engine those calls must all hit the same artifact.  Static engines
        yield themselves.
        """
        yield self

    def bind_telemetry(self, telemetry) -> None:
        """Attach the serving telemetry (``PathServer`` binds its own).
        Engines that emit no events of their own ignore it."""

    def buckets_of(self, s, t) -> np.ndarray:
        """[B] dispatch bucket per query (0 for single-bucket engines)."""
        return np.zeros(len(s), dtype=np.int32)

    def bucket_width(self, bucket: int) -> int:
        return 0

    @abc.abstractmethod
    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        ...

    def batch_argmin(self, s, t, bucket: int = 0):
        raise NotImplementedError(f"{self.name} has no argmin path")

    # -------------------------------------------- split-phase (async) path
    def stage(self, s, t, bucket: int = 0):
        """Begin staging one padded batch; returns an opaque handle for
        :meth:`dispatch_staged`.  Default: pass-through."""
        return (s, t)

    def dispatch_staged(self, staged, bucket: int = 0,
                        want_argmin: bool = False) -> Pending:
        """Dispatch a staged batch without waiting for its results; the
        caller owns ``Pending.wait``.  Default: the synchronous call."""
        s, t = staged
        if want_argmin:
            return Pending(tuple(self.batch_argmin(s, t, bucket=bucket)))
        return Pending((self.batch(s, t, bucket=bucket),))

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        pass

    def device_bytes(self) -> int:
        return 0


class HostEngine(QueryEngine):
    """Scalar float64 oracle looped over the batch — exact, no device state."""

    name = "host"

    def __init__(self, index: EHLIndex):
        self.index = index

    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        return np.array([host_query(self.index, si, ti, want_path=False)[0]
                         for si, ti in zip(s, t)], dtype=np.float32)

    def paths(self, s, t) -> list:
        return [host_query(self.index, si, ti, want_path=True)[1]
                for si, ti in zip(s, t)]


class _Slot:
    """One pinned staging slot: the batch's endpoints going in, its five
    result planes coming out, and the events that order them."""

    def __init__(self, rows: int):
        def pinned(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, pin_memory=True)

        self.s = pinned(rows, 2)
        self.t = pinned(rows, 2)
        self.outs = (pinned(rows), pinned(rows, dtype=torch.bool),
                     pinned(rows, dtype=torch.int32),
                     pinned(rows, dtype=torch.int32),
                     pinned(rows, dtype=torch.int32))
        self.copied = torch.cuda.Event()    # the H2D copies of s and t
        self.done = torch.cuda.Event()      # the D2H copies of the results
        self.busy = False                   # staged, results not yet read


class _Staged:
    """A batch staged on the card: its slot, the host endpoints (the
    rescue reads them) and the device endpoints the copies fill."""

    def __init__(self, slot, s, t, s_dev, t_dev):
        self.slot = slot
        self.s, self.t = s, t
        self.s_dev, self.t_dev = s_dev, t_dev


class DeviceEngine(QueryEngine):
    """Batched engine over a packed layout on its device.

    Each argmin batch a quantized artifact joins adds its slots (padding
    included) to ``argmin_rows_total{engine=}`` in the process-wide
    registry; each it rescues adds one to ``rescue_batches_total``, its
    ambiguous rows to ``rescue_rows_total`` and its host milliseconds to
    ``rescue_ms`` (same label).  A sampled request's trace gets child spans
    ``engine.upload``, ``engine.launch``, ``engine.readback`` and
    ``rescue`` for each synchronous call.

    On a CUDA artifact the split-phase path stages through a pool of
    pinned slots per batch shape (a slot is reused only once its results
    were read, so its copies are complete) and a copy stream of its own,
    and computes on the device's default stream, where the synchronous
    path also runs, so both draw on one pool of the caching allocator.
    ``stage``, ``dispatch_staged`` and ``Pending.wait`` of one engine run
    on one thread at a time (the batcher's serve loop).
    """

    use_kernels = False
    static_shapes = True    # fixed batch shapes: kernels see steady sizes

    def __init__(self, index, device="cuda", layout=LAYOUT_F32):
        if isinstance(index, EHLIndex):
            index = pack_bucketed(index, layout=layout, device=device)
        if not isinstance(index, (PackedIndex, BucketedIndex)):
            raise TypeError(f"unsupported index artifact: {type(index)!r}")
        self.index = index
        self.quantized = index.layout.quantized
        self.bucketed = isinstance(index, BucketedIndex)
        if self.bucketed:
            # host-side routing table mirrors (see _route)
            self._np_mapper = index.mapper.cpu().numpy()
            self._np_bucket = index.region_bucket.cpu().numpy()
        self._slots: dict[int, list[_Slot]] = {}    # batch rows -> pool
        self._copy_stream = None

    @property
    def num_buckets(self) -> int:
        return self.index.num_buckets if self.bucketed else 1

    def bucket_width(self, bucket: int) -> int:
        return (self.index.widths[bucket] if self.bucketed
                else self.index.label_width)

    def device_bytes(self) -> int:
        return self.index.device_bytes()

    def _route(self, pts) -> np.ndarray:
        """Host-numpy mirror of ``locate_regions`` -> bucket (the same
        float32 division, so cell ids agree with the device gathers bit for
        bit)."""
        p = np.asarray(pts, np.float32)
        cs = np.float32(self.index.cell_size)
        ix = np.clip((p[:, 0] / cs).astype(np.int32), 0, self.index.nx - 1)
        iy = np.clip((p[:, 1] / cs).astype(np.int32), 0, self.index.ny - 1)
        return self._np_bucket[self._np_mapper[iy * self.index.nx + ix]]

    def buckets_of(self, s, t) -> np.ndarray:
        if not self.bucketed:
            return np.zeros(len(s), dtype=np.int32)
        return np.maximum(self._route(s), self._route(t)).astype(np.int32)

    def _run(self, s, t, bucket: int, want_argmin: bool):
        """Upload a batch's endpoints and enqueue its fold and join (child
        spans ``engine.upload`` and ``engine.launch`` of a sampled
        request); the answers stay on the device."""
        with obs.span("engine.upload"):
            s, t = device_endpoints(self.index.device, s, t)
        with obs.span("engine.launch"):
            if self.bucketed:
                return query_batch_at_bucket(self.index, s, t, bucket=bucket,
                                             use_kernels=self.use_kernels,
                                             want_argmin=want_argmin)
            fn = query_batch_argmin if want_argmin else query_batch
            return fn(self.index, s, t, use_kernels=self.use_kernels)

    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        d = self._run(s, t, bucket, want_argmin=False)
        with obs.span("engine.readback"):
            # repolint: disable=hot-path-sync -- batch is the synchronous API; host results are its contract
            return d.cpu().numpy()

    def batch_argmin(self, s, t, bucket: int = 0):
        res = self._run(s, t, bucket, want_argmin=True)
        if not self.quantized:
            with obs.span("engine.readback"):
                # repolint: disable=hot-path-sync -- batch_argmin is the synchronous API; host results are its contract
                return tuple(r.cpu().numpy() for r in res)
        # quantized: 6-tuple — rescue ambiguous-margin rows against the
        # exact residual so argmin winners match the f32 engine bit for bit
        # (one flag read decides)
        with obs.span("engine.readback"):
            # repolint: disable=hot-path-sync -- documented rescue trigger: one flag word, the exactness contract pays this sync
            amb = res[5].cpu().numpy()
        self._count_argmin(amb)
        if not amb.any():
            with obs.span("engine.readback"):
                # repolint: disable=hot-path-sync -- batch_argmin is the synchronous API; host results are its contract
                return tuple(r.cpu().numpy() for r in res[:5])
        return self._rescue(res, amb, s, t, bucket)

    def _count_argmin(self, amb: np.ndarray) -> None:
        """A quantized argmin batch joined: its slots, padding included."""
        obs.REGISTRY.counter("argmin_rows_total", engine=self.name).inc(
            len(amb))

    def _rescue(self, res, amb: np.ndarray, s, t, bucket: int) -> tuple:
        """Splice the exact answers of the ambiguous rows into ``res``
        (child span ``rescue`` of a sampled request, ``rescue.splice``
        below it, and ``rescue_exact``'s)."""
        with obs.Stopwatch() as sw, obs.span("rescue"):
            # repolint: disable=hot-path-sync -- exact rescue is the sanctioned sync: rescue_exact copies the residual rows to the device (DESIGN.md §11)
            exact = rescue_exact(self.index, s, t, self.bucket_width(bucket),
                                 res[1], use_kernels=self.use_kernels)
            with obs.span("rescue.splice"):
                out = splice_rescue((*res[:5], amb), exact)  # repolint: disable=hot-path-sync -- part of the sanctioned rescue sync above: the host splice reads both answers
        reg = obs.REGISTRY
        reg.counter("rescue_rows_total", engine=self.name).inc(
            int(np.count_nonzero(amb)))
        reg.counter("rescue_batches_total", engine=self.name).inc()
        reg.histogram("rescue_ms", engine=self.name).record(sw.seconds * 1e3)
        return out

    # -------------------------------------------- split-phase (async) path
    def _on_card(self) -> bool:
        return self.index.device.type == "cuda"

    def _slot(self, rows: int) -> _Slot:
        """A free pinned slot for a batch of ``rows``; a new one (a cold
        event, counted in ``TRACES``) when every slot is busy."""
        pool = self._slots.setdefault(rows, [])
        for slot in pool:
            if not slot.busy:
                break
        else:
            TRACES.see("stage", "cuda", rows, len(pool))
            slot = _Slot(rows)
            pool.append(slot)
        # never rewrite a slot mid-copy
        # repolint: disable=hot-path-sync -- a free slot's batch was retired (Pending.wait, or the rescue's flag read) after the compute stream waited on this event, so it has completed and this returns at once; only a slot freed by a failed dispatch can wait here
        slot.copied.synchronize()
        slot.busy = True
        return slot

    def stage(self, s, t, bucket: int = 0):
        """Copy a padded batch into a pinned slot and start its host-to-
        device copies on the copy stream (CUDA); pass-through elsewhere."""
        if not self._on_card():
            return super().stage(s, t, bucket)
        dev = self.index.device
        # repolint: disable=hot-path-sync -- normalizes host inputs before the H2D enqueue; nothing lives on device yet
        s = np.asarray(s, np.float32)
        t = np.asarray(t, np.float32)  # repolint: disable=hot-path-sync -- same host-input normalization as the line above
        slot = self._slot(len(s))
        slot.s.numpy()[:] = s
        slot.t.numpy()[:] = t
        with torch.cuda.device(dev):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(self._copy_stream):
                s_dev = slot.s.to(dev, non_blocking=True)
                t_dev = slot.t.to(dev, non_blocking=True)
                slot.copied.record(self._copy_stream)
        return _Staged(slot, s, t, s_dev, t_dev)

    def dispatch_staged(self, staged, bucket: int = 0,
                        want_argmin: bool = False) -> Pending:
        """Launch a staged batch without waiting for the device (CUDA).

        The compute stream waits on the slot's copy event, runs the fold
        and join, and copies the results into the slot's pinned planes;
        the returned :class:`Pending` waits on that copy.  The one host
        synchronisation is a quantized argmin's ambiguity flag, read to
        decide the rescue, as ``batch_argmin`` reads it.
        """
        if not isinstance(staged, _Staged):
            if self._on_card():
                raise TypeError("a CUDA engine dispatches only what its "
                                "stage() staged")
            return super().dispatch_staged(staged, bucket, want_argmin)
        slot = staged.slot
        dev = self.index.device
        compute = torch.cuda.default_stream(dev)
        try:
            with torch.cuda.device(dev), torch.cuda.stream(compute):
                compute.wait_event(slot.copied)
                # made on the copy stream, read on this one: the allocator
                # must not hand their memory out before this stream is done
                staged.s_dev.record_stream(compute)
                staged.t_dev.record_stream(compute)
                res = self._run(staged.s_dev, staged.t_dev, bucket,
                                want_argmin)
                if not want_argmin:
                    res = (res,)
                elif self.quantized:
                    # repolint: disable=hot-path-sync -- documented rescue trigger: one flag word, the exactness contract pays this sync
                    amb = res[5].cpu().numpy()
                    self._count_argmin(amb)
                    if amb.any():
                        slot.busy = False
                        return Pending(self._rescue(res, amb, staged.s,
                                                    staged.t, bucket))
                    res = res[:5]
                for o, r in zip(slot.outs, res):
                    o.copy_(r, non_blocking=True)
                slot.done.record(compute)
        except BaseException:
            slot.busy = False
            raise
        return Pending([o.numpy() for o in slot.outs[:len(res)]],
                       done=slot.done, slot=slot)

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        """Run every bucket once at the serving batch shape, so the kernels
        are built and loaded, and the device allocator has seen the serving
        sizes, before live traffic.  On a quantized artifact the argmin
        warmup also runs the rescue's exact gather and join once.  On the
        card the split-phase path runs too, through ``STAGING_SLOTS``
        batches in flight, so the first async batch pays no pinned-buffer
        or stream setup."""
        z = np.zeros((batch_size, 2), np.float32)
        dev = self.index.device
        for b in range(self.num_buckets):
            self.batch(z, z, b)
            if want_argmin:
                self.batch_argmin(z, z, b)
                if self.quantized:
                    W = self.bucket_width(b)
                    zt = torch.zeros((batch_size, 2), dtype=torch.float32,
                                     device=dev)
                    d0 = torch.full((batch_size, W), float("inf"),
                                    dtype=torch.float32, device=dev)
                    ms = gather_masked_exact(self.index, zt, d0, W,
                                             use_kernels=self.use_kernels)
                    join_masked(ms, ms, zt, zt,
                                torch.zeros(batch_size, dtype=torch.bool,
                                            device=dev),
                                use_kernels=self.use_kernels,
                                want_argmin=True)
            if self._on_card():
                for argmin in (False, True) if want_argmin else (False,):
                    pending = [self.dispatch_staged(self.stage(z, z, b), b,
                                                    argmin)
                               for _ in range(STAGING_SLOTS)]
                    for p in pending:
                        p.wait()


class TorchEngine(DeviceEngine):
    name = "torch"
    use_kernels = False


class CudaEngine(DeviceEngine):
    name = "cuda"
    use_kernels = True


def replicate_artifact(art, device):
    """A copy of a packed artifact (PackedIndex / BucketedIndex, its edge
    grid included) with every tensor on ``device``; host-side fields (the
    quantized layout's residual table) are shared."""
    dev = torch.device(device)

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(dev)
        if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            return tuple(a.to(dev) for a in v)
        if dataclasses.is_dataclass(v) and not isinstance(v, type) and \
                any(isinstance(getattr(v, f.name), torch.Tensor)
                    for f in dataclasses.fields(v)):
            return replicate_artifact(v, dev)
        return v

    return dataclasses.replace(art, **{
        f.name: move(getattr(art, f.name)) for f in dataclasses.fields(art)
        if f.init})


def make_engine(index, backend: str = "cuda", device="cuda",
                layout=LAYOUT_F32) -> QueryEngine:
    """Engine factory.  ``index``: EHLIndex (host backend, or packed
    bucketed onto ``device`` for the device backends, which raises when
    ``device`` is CUDA and no card is present), PackedIndex or
    BucketedIndex (served on the device that holds it).  ``layout`` picks
    the slab dtypes when packing (DESIGN.md §11)."""
    if backend == "host":
        if not isinstance(index, EHLIndex):
            raise TypeError("host backend needs the host-side EHLIndex")
        return HostEngine(index)
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected host | torch | cuda)")
    cls = CudaEngine if backend == "cuda" else TorchEngine
    return cls(index, device=device, layout=layout)
