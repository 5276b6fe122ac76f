"""Wrapper of the Hopper gathered-tile visibility kernel
(``csrc/segvis_tiles.cu``).

Replaces the TPU kernel ``repro/kernels/segvis.py:_segvis_tiles_kernel``.
The edge-grid path's visibility test: each of N segments against its own S
edge slots, gathered by the grid walk into six [N, S] float32 planes, with
the same banded predicate as ``segvis`` and an OR over the slots.  With the
tiles materialised the kernel is bound by bytes on the H100; see the source
note for the design.  Its plain twin is ``ref.segvis_tiles_ref``;
``kernels.ops`` picks between them by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, launches
from .segvis import _check as _check_points

PLANES = ("ax", "ay", "bx", "by", "cx", "cy")


def _check_plane(name: str, x: torch.Tensor, device, n: int, s: int):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != (n, s):
        raise ValueError(f"{name} must be [{n}, {s}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = build.load("segvis_tiles")
    fn = lib.segvis_tiles_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def segvis_tiles(p: torch.Tensor, q: torch.Tensor,
                 ax: torch.Tensor, ay: torch.Tensor,
                 bx: torch.Tensor, by: torch.Tensor,
                 cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """[N] bool visibility through the CUDA kernel (CUDA tensors only).

    p, q: [N, 2] float32; ax..cy: [N, S] float32, all contiguous on one
    CUDA device.  Launches on the current stream without synchronising;
    raises if the launch fails.
    """
    if p.device.type != "cuda":
        raise ValueError(
            f"segvis_tiles launches on CUDA tensors only, got {p.device}")
    _check_points("p", p, p.device)
    _check_points("q", q, p.device)
    n = p.shape[0]
    if q.shape[0] != n:
        raise ValueError("p and q must agree in length")
    if ax.dim() != 2:
        raise ValueError(f"ax must be [n, s], got {tuple(ax.shape)}")
    s = ax.shape[1]
    planes = (ax, ay, bx, by, cx, cy)
    for name, x in zip(PLANES, planes):
        _check_plane(name, x, p.device, n, s)
    out = torch.empty(n, dtype=torch.uint8, device=p.device)
    if n == 0:
        return out == 0
    launch = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(p.data_ptr(), q.data_ptr(),
                     *(x.data_ptr() for x in planes), out.data_ptr(), n, s,
                     stream)
    if err:
        raise RuntimeError(f"segvis_tiles launch failed: cudaError {err}")
    launches.count(segvis_tiles, "segvis_tiles", (n, s))
    return out == 0


segvis_tiles.launches = 0
