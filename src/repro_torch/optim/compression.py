"""Gradient compression for the data-parallel all-reduce (the port of
``repro.optim.compression``).

int8 quantized all-reduce with error feedback: each data-parallel rank
quantizes its local gradient to int8 with a shared per-tensor scale (an
all-reduce of the max), all-reduces the int8 payload in an int32
accumulator, dequantizes, and keeps the quantization residual locally,
adding it back into the next step's gradient.  The reduces run over a
``torch.distributed`` process group; with no group, or a group of one
rank, they are the identity, as the reference's psum is on one device.
``compress_psum_ref`` is the numerics oracle for tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map, unflatten


def _world(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _all_reduce(t, op: str, group):
    """``t`` reduced over ``group`` (a new tensor); the identity on one
    rank."""
    if _world(group) == 1:
        return t
    import torch.distributed as dist

    out = t.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op), group=group)
    return out


def quantize_psum(g, residual, group=None):
    """Error-feedback int8 all-reduce of one tensor over ``group``.

    Returns (mean gradient float32, new residual)."""
    gf = g.float() + residual
    scale = torch.max(torch.abs(gf)) / 127.0
    scale = _all_reduce(scale, "MAX", group) + 1e-12     # shared scale
    q = torch.clamp(torch.round(gf / scale), -127, 127)  # int8 payload
    deq = q * scale
    new_residual = gf - deq
    total = _all_reduce(q.to(torch.int32), "SUM", group)  # int32 accumulator
    return (total.float() * scale) / float(_world(group)), new_residual


def compress_psum_tree(grads, residuals, group=None):
    """:func:`quantize_psum` leaf by leaf over a gradient tree."""
    fg, fr = flatten(grads), flatten(residuals)
    out = {k: quantize_psum(g, fr[k], group) for k, g in fg.items()}
    return (unflatten({k: o[0] for k, o in out.items()}),
            unflatten({k: o[1] for k, o in out.items()}))


def init_residuals(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_psum_ref(local_grads: list, residuals: list):
    """Host-side oracle: emulate N workers' quantize/psum for tests."""
    gf = [np.asarray(g, np.float32) + np.asarray(r, np.float32)
          for g, r in zip(local_grads, residuals)]
    scale = max(np.max(np.abs(x)) for x in gf) / 127.0 + 1e-12
    qs = [np.clip(np.round(x / scale), -127, 127) for x in gf]
    new_res = [x - q * scale for x, q in zip(gf, qs)]
    mean = sum(qs) * scale / len(qs)
    return mean, new_res
