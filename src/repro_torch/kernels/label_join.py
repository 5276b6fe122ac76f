"""Wrapper of the Hopper hub-label row-join kernel (``csrc/label_join.cu``).

Replaces the TPU kernel ``repro/kernels/label_join.py:_join_kernel``: the
[B, L] row join ``out[b, i] = vd_s[b, i] + min_{j: hub_t[b, j] ==
hub_s[b, i]} vd_t[b, j]``, in the paper's sorted form (Eq. 3).  The main
path's label rows are sorted by hub with ``HUB_PAD`` at the tail, so one
hub's t-labels form one run: the kernel folds each run to its minimum once
and finds it for every s-label by binary search, bound by the 20 B L bytes
it reads and writes.  A chunk of a row whose hubs are not sorted takes the
dense scan inside the same kernel, so any row gives the twin's bits.
Distances may be float32, bfloat16 or float16 (one type for both sides);
the kernel widens narrow ones to float32 as it loads them, as the TPU
kernel's wrapper does, and always returns float32.  The serving path
passes float32 only (the gather widens quantized slabs and the fold adds a
float32 norm); the narrow types are the entry point's contract for direct
callers.  Precondition: no distance is NaN or -0 (every caller passes sums
of norms and label distances, or +inf); then min is exact and order-free.  Rows up
to 16384 labels are staged in shared memory at once, wider rows in chunks
of that size.  Its plain twin is ``ref.label_join_rowmin_ref``;
``kernels.ops`` picks between them by the device of the tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


# the distance types the kernel loads, by the code its launcher takes
# (JOIN_F32 / JOIN_BF16 / JOIN_F16 in csrc/label_join.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib():
    lib = build.load("label_join")
    fn = lib.label_join_rowmin_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def label_join_rowmin(hub_s: torch.Tensor, vd_s: torch.Tensor,
                      hub_t: torch.Tensor, vd_t: torch.Tensor
                      ) -> torch.Tensor:
    """[B, L] float32 row join through the CUDA kernel (CUDA tensors only).

    Hubs int32, distances float32, bfloat16 or float16 with both sides of
    one type, all [B, L], contiguous, on one CUDA device.  Launches on the
    current stream without synchronising; raises if the launch fails.
    """
    dev = hub_s.device
    if dev.type != "cuda":
        raise ValueError(f"label_join_rowmin launches on CUDA tensors only, "
                         f"got {dev}")
    if vd_s.dtype not in _DTYPE_CODES:
        raise TypeError(f"vd_s must be one of {list(_DTYPE_CODES)}, got "
                        f"{vd_s.dtype}")
    shape = hub_s.shape
    for name, x, dtype in (("hub_s", hub_s, torch.int32),
                           ("vd_s", vd_s, vd_s.dtype),
                           ("hub_t", hub_t, torch.int32),
                           ("vd_t", vd_t, vd_s.dtype)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 2 or x.shape != shape:
            raise ValueError(f"{name} must be [B, L] = {tuple(shape)}, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, L = shape
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return out
    launch = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(hub_s.data_ptr(), vd_s.data_ptr(), hub_t.data_ptr(),
                     vd_t.data_ptr(), out.data_ptr(), B, L,
                     _DTYPE_CODES[vd_s.dtype], stream)
    if err:
        raise RuntimeError(f"label_join_rowmin launch failed: cudaError {err}")
    label_join_rowmin.launches += 1
    return out


label_join_rowmin.launches = 0

