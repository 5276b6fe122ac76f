"""Serving placement: which device holds each region shard.

A "mesh" here is a tuple of ``torch.device``: the port serves a
region-sharded index (``repro_torch.sharding``) with one shard's slabs per
device.  Importing this module touches no device state.
"""

from __future__ import annotations

import torch

from repro_torch.core.packed import resolve_device


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
