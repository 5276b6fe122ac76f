"""Kernel / twin dispatch by device.

``*_kernel`` entry points launch the Hopper kernel for CUDA tensors and run
the plain twin (``kernels.ref``) for CPU tensors — only because the tensor
lies on the CPU, where no CUDA kernel can run.  A launch that fails raises;
nothing falls back.  ``*_ref`` entry points are the twins themselves, which
``core.packed`` calls when ``use_kernels`` is False (the TorchEngine).
"""

from __future__ import annotations

import torch

from . import ref as _ref
from .label_join import label_join_rowmin as _label_join_rowmin_cuda
from .segvis import segvis as _segvis_cuda
from .segvis_tiles import segvis_tiles as _segvis_tiles_cuda

segvis_ref = _ref.segvis_ref
segvis_tiles_ref = _ref.segvis_tiles_ref
label_join_ref = _ref.label_join_ref
label_join_rowmin_ref = _ref.label_join_rowmin_ref
label_join_hubdense_ref = _ref.label_join_hubdense_ref


def segvis_kernel(p: torch.Tensor, q: torch.Tensor, ea: torch.Tensor,
                  eb: torch.Tensor, ec: torch.Tensor | None = None
                  ) -> torch.Tensor:
    if p.device.type == "cpu":
        return _ref.segvis_ref(p, q, ea, eb, ec)
    return _segvis_cuda(p, q, ea, eb, ec)


def segvis_tiles_kernel(p: torch.Tensor, q: torch.Tensor,
                        ax: torch.Tensor, ay: torch.Tensor,
                        bx: torch.Tensor, by: torch.Tensor,
                        cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return _ref.segvis_tiles_ref(p, q, ax, ay, bx, by, cx, cy)
    return _segvis_tiles_cuda(p, q, ax, ay, bx, by, cx, cy)


def label_join_rowmin_kernel(hub_s: torch.Tensor, vd_s: torch.Tensor,
                             hub_t: torch.Tensor, vd_t: torch.Tensor
                             ) -> torch.Tensor:
    if hub_s.device.type == "cpu":
        return _ref.label_join_rowmin_ref(hub_s, vd_s, hub_t, vd_t)
    return _label_join_rowmin_cuda(hub_s, vd_s, hub_t, vd_t)


def label_join_kernel(hub_s: torch.Tensor, vd_s: torch.Tensor,
                      hub_t: torch.Tensor, vd_t: torch.Tensor
                      ) -> torch.Tensor:
    """[B] float32 Eq. 3 distances: the row join, then its minimum over L.

    On CUDA tensors the ``label_join_rowmin`` kernel, then ``torch.amin``
    over the row (the reference's ``label_join`` also takes that minimum
    outside its Pallas kernel).  No engine path calls it; the serving join
    needs the row for its argmin."""
    if hub_s.device.type == "cpu":
        return _ref.label_join_ref(hub_s, vd_s, hub_t, vd_t)
    out = _label_join_rowmin_cuda(hub_s, vd_s, hub_t, vd_t).amin(dim=-1)
    label_join_kernel.launches += 1
    return out


label_join_kernel.launches = 0
