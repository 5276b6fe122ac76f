"""Pluggable query backends behind one ``QueryEngine`` interface.

The serving layer (``PathServer``) is backend-agnostic: it routes batches,
keeps stats and scatters results; *how* a batch is answered is an engine
(DESIGN.md §6).  Three interchangeable backends:

* :class:`HostEngine`  — the scalar float64 oracle (``core.query``); slow,
  exact, the reference everything else is validated against.
* :class:`TorchEngine` — the batched engine over a :class:`BucketedIndex`
  with the plain PyTorch twins of the kernels.
* :class:`CudaEngine`  — the same engine through the Hopper kernels
  (``kernels.ops``; on CPU tensors that dispatch runs the twins).

The two device engines share the query core in ``core.packed`` and differ
only in its ``use_kernels`` flag.  On a quantized artifact (DESIGN.md §11)
``batch_argmin`` rescues the rows the join flags as ambiguous against the
exact residual rows, so its winners equal the f32 engine's bit for bit.
"""

from __future__ import annotations

import abc
import time

import numpy as np
import torch

from repro_torch.core.grid import EHLIndex
from repro_torch.core.packed import (LAYOUT_F32, BucketedIndex,
                                     gather_masked_exact, join_masked,
                                     pack_bucketed, query_batch_at_bucket,
                                     rescue_exact, splice_rescue)
from repro_torch.core.query import query as host_query


class QueryEngine(abc.ABC):
    """Answer batches of ESPP queries; optionally bucket-routable.

    ``bucket`` arguments index the engine's dispatch buckets; the host
    oracle has one bucket and ignores them.  ``batch`` returns [B] float32
    distances; ``batch_argmin`` also returns the winning (covis, via_s,
    hub, via_t) ids for host-side path unwinding.  Both return numpy.
    """

    name: str = "abstract"
    static_shapes = False   # True: batches are padded to a fixed size

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

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        pass


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


class DeviceEngine(QueryEngine):
    """Batched engine over a :class:`BucketedIndex` on its device.

    ``rescue_batches``/``rescue_rows``/``rescue_seconds`` count the argmin
    batches a quantized artifact rescued, the ambiguous rows in them and
    the host seconds the rescues took.
    """

    use_kernels = False
    static_shapes = True    # fixed batch shapes: kernels see steady sizes

    def __init__(self, index, device="cuda", layout=LAYOUT_F32):
        if isinstance(index, EHLIndex):
            index = pack_bucketed(index, layout=layout, device=device)
        if not isinstance(index, BucketedIndex):
            raise TypeError(f"unsupported index artifact: {type(index)!r}")
        self.index = index
        self.quantized = index.layout.quantized
        self.rescue_batches = 0
        self.rescue_rows = 0
        self.rescue_seconds = 0.0
        # host-side routing table mirrors (see _route)
        self._np_mapper = index.mapper.cpu().numpy()
        self._np_bucket = index.region_bucket.cpu().numpy()

    @property
    def num_buckets(self) -> int:
        return self.index.num_buckets

    def bucket_width(self, bucket: int) -> int:
        return self.index.widths[bucket]

    def _route(self, pts) -> np.ndarray:
        """Host-numpy mirror of ``locate_regions`` -> bucket (same float32
        floor-divide, so cell ids agree with the device gathers bit for
        bit)."""
        p = np.asarray(pts, np.float32)
        cs = np.float32(self.index.cell_size)
        ix = np.clip((p[:, 0] / cs).astype(np.int32), 0, self.index.nx - 1)
        iy = np.clip((p[:, 1] / cs).astype(np.int32), 0, self.index.ny - 1)
        return self._np_bucket[self._np_mapper[iy * self.index.nx + ix]]

    def buckets_of(self, s, t) -> np.ndarray:
        return np.maximum(self._route(s), self._route(t)).astype(np.int32)

    def _run(self, s, t, bucket: int, want_argmin: bool):
        return query_batch_at_bucket(self.index, s, t, bucket=bucket,
                                     use_kernels=self.use_kernels,
                                     want_argmin=want_argmin)

    def batch(self, s, t, bucket: int = 0) -> np.ndarray:
        return self._run(s, t, bucket, want_argmin=False).cpu().numpy()

    def batch_argmin(self, s, t, bucket: int = 0):
        res = self._run(s, t, bucket, want_argmin=True)
        if not self.quantized:
            return tuple(r.cpu().numpy() for r in res)
        # quantized: 6-tuple — rescue ambiguous-margin rows against the
        # exact residual so argmin winners match the f32 engine bit for bit
        # (one flag read decides)
        amb = res[5].cpu().numpy()
        if not amb.any():
            return tuple(r.cpu().numpy() for r in res[:5])
        t0 = time.perf_counter()
        exact = rescue_exact(self.index, s, t, self.bucket_width(bucket),
                             res[1], use_kernels=self.use_kernels)
        out = splice_rescue((*res[:5], amb), exact)
        self.rescue_seconds += time.perf_counter() - t0
        self.rescue_batches += 1
        self.rescue_rows += int(np.count_nonzero(amb))
        return out

    def warmup(self, batch_size: int, want_argmin: bool = False) -> None:
        """Run every bucket once at the serving batch shape, so the kernels
        are built and loaded, and the device allocator has seen the serving
        sizes, before live traffic.  On a quantized artifact the argmin
        warmup also runs the rescue's exact gather and join once."""
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


class TorchEngine(DeviceEngine):
    name = "torch"
    use_kernels = False


class CudaEngine(DeviceEngine):
    name = "cuda"
    use_kernels = True


def make_engine(index, backend: str = "cuda", device="cuda",
                layout=LAYOUT_F32) -> QueryEngine:
    """Engine factory.  ``index``: EHLIndex (host backend, or packed onto
    ``device`` for the device backends, which raises when ``device`` is
    CUDA and no card is present) or a BucketedIndex (served on the device
    that holds it).  ``layout`` picks the slab dtypes when packing
    (DESIGN.md §11)."""
    if backend == "host":
        if not isinstance(index, EHLIndex):
            raise TypeError("host backend needs the host-side EHLIndex")
        return HostEngine(index)
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected host | torch | cuda)")
    cls = CudaEngine if backend == "cuda" else TorchEngine
    return cls(index, device=device, layout=layout)
