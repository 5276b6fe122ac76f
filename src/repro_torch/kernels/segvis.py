"""Wrapper of the Hopper segment-visibility kernel (``csrc/segvis.cu``).

Replaces the TPU kernel ``repro/kernels/segvis.py:_segvis_kernel``.  The
query-phase hot spot of EHL: every query point tests visibility against
every via vertex of its region — N = B*W segments against E obstacle edges,
~84 float32 operations per (segment, edge) pair with an OR over the edges.
The kernel is bound by operations on the H100; see the source note for the
design.  Its plain twin is ``ref.segvis_ref``; ``kernels.ops`` picks
between them by the device of the tensors.
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


def _lib():
    lib = build.load("segvis")
    fn = lib.segvis_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    out = torch.empty(n, dtype=torch.uint8, device=p.device)
    if n == 0:
        return out == 0
    launch = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(p.data_ptr(), q.data_ptr(), ea.data_ptr(), eb.data_ptr(),
                     ec.data_ptr(), out.data_ptr(), n, e, stream)
    if err:
        raise RuntimeError(f"segvis launch failed: cudaError {err}")
    segvis.launches += 1
    return out == 0


segvis.launches = 0
