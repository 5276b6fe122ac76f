"""Meshes: the LM's ``DeviceMesh`` and the serving placement.

An LM mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``("data", "model")`` for a pod, ``("pod", "data",
"model")`` for a multipod), built by ``distributed.compat.make_mesh``.  A
serving "mesh" is a tuple of ``torch.device``: the port serves a
region-sharded index (``repro_torch.sharding``) with one shard's slabs per
device, and ``PathServer(batch_sharding=)`` splits each batch over it.
Importing this module touches no device state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packed import resolve_device
from repro_torch.distributed.compat import make_mesh

#: ranks of the production meshes: one pod of 16x16, two pods of 16x16
POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The 16x16 pod mesh or the 2x16x16 multipod mesh over the default
    group, which must hold 256 or 512 ranks (``torchrun`` across the hosts,
    or the dry run's fake group).

    Axes: ``pod`` spans the link between pods (data-parallel by default,
    pipeline stages opt-in); ``data`` is batch/FSDP; ``model`` is
    tensor/expert parallel.
    """
    import torch.distributed as dist

    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(f"the {'multipod' if multi_pod else 'pod'} mesh "
                         f"{shape} needs {want} ranks, the world has "
                         f"{world} (launch with torchrun across the hosts)")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """A ``("data", "model")`` mesh over the ranks there are (one rank
    with no launcher): tests and single-host runs."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import ensure_process_group

    ensure_process_group(device)
    n = dist.get_world_size()
    model_axis = max(1, min(model_axis, n))
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{n} ranks")
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device=device)


def axis_names(mesh) -> tuple:
    """A mesh's axis names: a ``DeviceMesh``'s dim names, or the keys of a
    stand-in's ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.shape)


def axis_size(mesh, name: str) -> int:
    """The size of one named axis of a ``DeviceMesh`` or a stand-in with a
    ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return int(mesh.size(list(names).index(name)))
    return int(mesh.shape[name])


def data_axes(mesh) -> tuple:
    """The axes a global batch shards over (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def make_serving_mesh(num_shards: int) -> tuple:
    """The first ``num_shards`` CUDA devices, one shard each.

    Raises when the machine has fewer cards than shards — callers that want
    oversubscription (one card, or the CPU in tests) pass ``mesh=None``,
    and :func:`shard_devices` round-robins the shards onto what exists.
    """
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if num_shards > n:
        raise ValueError(f"need {num_shards} CUDA devices for a serving "
                         f"mesh, this machine has {n} (pass mesh=None to "
                         "round-robin the shards onto the devices there are)")
    return tuple(torch.device("cuda", k) for k in range(num_shards))


def shard_devices(mesh, num_shards: int, device="cuda") -> list:
    """Per-shard device placement: mesh devices, or a round-robin.

    With a mesh, shard ``k`` lives on ``mesh[k]`` (one shard per device).
    Without one, the shards go onto the devices of ``device``'s type: a
    bare ``cuda`` round-robins over every card (so on a one-card machine
    all shards share ``cuda:0``, and cross-shard copies are same-device
    no-ops), ``cuda:k`` puts every shard on card ``k``, ``cpu`` on the CPU.
    ``cuda`` raises without a card.
    """
    if mesh is not None:
        devs = [resolve_device(d) for d in mesh]
        if len(devs) < num_shards:
            raise ValueError(f"mesh has {len(devs)} devices for "
                             f"{num_shards} shards")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"a mesh holds devices of one type: {devs}")
        return devs[:num_shards]
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * num_shards
    n = torch.cuda.device_count()
    return [torch.device("cuda", k % n) for k in range(num_shards)]
