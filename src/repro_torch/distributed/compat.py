"""One place where every LM mesh is built (the port of
``repro.distributed.compat``).

The reference's module shims the drift of ``jax.make_mesh`` across jax
releases; PyTorch has no such drift, and the module keeps its name so a
reader finds the counterpart of :func:`make_mesh`.  An LM mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, made by ``init_device_mesh`` over the default process group.  With
no group, :func:`make_mesh` first makes a one-rank group on a
``dist.HashStore()`` (NCCL for the card, gloo for the CPU): one default
group per process, so a run on another world (the fake-rank dry run) takes
a process of its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core.packed import resolve_device


def ensure_process_group(device="cuda") -> None:
    """Make a one-rank default group when the process has none, and pin
    this rank's card.  ``torchrun`` (or a test's spawn) makes the group
    first; its env, never a flag here, decides the world."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
            kw["device_id"] = torch.device("cuda", dev.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    elif dev.type == "cuda" and dist.get_backend() == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def make_mesh(axis_shapes, axis_names, *, device="cuda"):
    """``init_device_mesh`` over the default group (made if missing);
    ``device`` gives the mesh's device type."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    return init_device_mesh(dev.type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))
