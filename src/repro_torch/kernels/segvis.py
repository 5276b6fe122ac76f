"""Wrapper of the Hopper segment-visibility kernel (``csrc/segvis.cu``).

Replaces the TPU kernel ``repro/kernels/segvis.py:_segvis_kernel``.  The
query-phase hot spot of EHL: every query point tests visibility against
every via vertex of its region — N = B*W segments against E obstacle edges,
34 float32 operations per (segment, edge) pair once the segment's and the
edge's own terms are hoisted, with an OR over the edges.  The kernel is
bound by instruction issue on the H100 (no operation fuses into an fma, for
bit equality), so it does fewer: it skips the padding edges (a == b, which
never block), and a group of G lanes takes one segment, strides its edges
and stops at the first step in which a lane blocks.  :func:`launch_shape`
picks G and the block size from N so that every launch of the main path
fills the card's SMs.  The bits equal the twin's because
every step rounds as the twin's does (``csrc/blocked_pairs.cuh``) and OR
is monotone.  The kernel writes the visibility bit straight into a
``torch.bool`` tensor.  Its plain twin is ``ref.segvis_ref``;
``kernels.ops`` picks between them by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


def _check(name: str, x: torch.Tensor, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 2:
        raise ValueError(f"{name} must be [n, 2], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 8:
        raise ValueError(f"{name} must be 8-byte aligned (float2 loads)")


# H100 SXM: streaming multiprocessors
SMS = 132
BLOCK_THREADS = 256


def launch_shape(n: int) -> tuple[int, int]:
    """(G, threads per block) for N segments.

    G, the lanes per segment, is the smallest power of two up to 32 that
    gives N*G at least two warps per SM: one lane per segment on the fold
    (N = 256*W), a warp per segment on the co-visibility launch (N = 256).
    The fastest G measured on the main path's own segments (PERF.md); more
    lanes than that only add votes and per-segment setup.  The block size
    is :func:`block_threads`.
    """
    group = 1
    while group < 32 and n * group < SMS * 64:
        group *= 2
    return group, block_threads(n, group)


def block_threads(n: int, group: int) -> int:
    """Threads per block for N segments at G lanes each: 256, halved (down
    to one warp) while the launch has fewer blocks than the card has SMs."""
    threads = BLOCK_THREADS
    while threads > 32 and -(-n * group // threads) < SMS:
        threads //= 2
    return threads


def _lib():
    lib = build.load("segvis")
    fn = lib.segvis_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(p, q, ea, eb, ec, out, group: int, threads: int) -> None:
    """One launch at an explicit (G, threads); raises if it fails."""
    launch = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(p.data_ptr(), q.data_ptr(), ea.data_ptr(), eb.data_ptr(),
                     ec.data_ptr(), out.data_ptr(), p.shape[0], ea.shape[0],
                     group, threads, stream)
    if err:
        raise RuntimeError(f"segvis launch failed: cudaError {err}")


def segvis(p: torch.Tensor, q: torch.Tensor, ea: torch.Tensor,
           eb: torch.Tensor, ec: torch.Tensor | None = None) -> torch.Tensor:
    """[N] bool visibility through the CUDA kernel (CUDA tensors only).

    p, q: [N, 2] float32; ea, eb, ec: [E, 2] float32, all contiguous on one
    CUDA device.  ``ec`` defaults to ``eb`` (vertex rule off).  Launches on
    the current stream without synchronising; raises if the launch fails.
    """
    if ec is None:
        ec = eb
    if p.device.type != "cuda":
        raise ValueError(f"segvis launches on CUDA tensors only, got {p.device}")
    for name, x in (("p", p), ("q", q), ("ea", ea), ("eb", eb), ("ec", ec)):
        _check(name, x, p.device)
    n, e = p.shape[0], ea.shape[0]
    if q.shape[0] != n or eb.shape[0] != e or ec.shape[0] != e:
        raise ValueError("p/q and ea/eb/ec must agree in length")
    out = torch.empty(n, dtype=torch.bool, device=p.device)
    if n == 0:
        return out
    _launch(p, q, ea, eb, ec, out, *launch_shape(n))
    segvis.launches += 1
    return out


segvis.launches = 0
