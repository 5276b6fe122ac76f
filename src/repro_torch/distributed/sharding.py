"""Sharding rules: parameter, batch and cache specs per architecture (the
port of ``repro.distributed.sharding``).

Strategy (DTensor sharding propagation, the port's counterpart of GSPMD):

* **FSDP + TP**: every weight matrix shards its feature axes over ``model``
  (TP) and, when the remaining axis is large, over ``data`` (ZeRO-3-style
  FSDP); DTensor's propagation inserts the all-gathers.
* **EP**: MoE expert tensors [L, E, d, f] shard E over ``model``;
  ``distributed.moe_ep`` moves tokens with an explicit all-to-all.
* **pod** joins the batch axes (pure DP across pods) unless pipeline mode
  assigns it to stages (``distributed.pipeline``).

A *spec* is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim: an axis name, a tuple of axis names, or None.  DTensor wants
*placements*, one per mesh dim: :func:`placements` turns one into the
other.  Rules are name patterns over the ``/``-joined key path, first match
wins; one table drives all ten architectures.
"""

from __future__ import annotations

import re

import numpy as np

from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.tree import flatten, unflatten


# (path regex, spec) — first match wins.  `dp` is the FSDP axis name, `mp`
# the tensor axis name.  Layer-stacked leaves have a leading L axis (never
# sharded).
def _rules(dp, mp):
    return [
        # embeddings / unembed: vocab over model, feature over data
        (r"embed$",               (mp, dp)),
        (r"unembed$",             (dp, mp)),
        # MoE: experts over model (EP), expert-internal over data (FSDP)
        (r"moe/router$",          (None, dp, None)),
        (r"moe/w[gud]$",          (None, mp, dp, None)),
        (r"moe/shared/w[gud]$",   (None, dp, mp)),
        # attention projections: [L, d, H*hd] -> feature over model
        (r"attn/w[qkv]$",         (None, dp, mp)),
        (r"attn/wo$",             (None, mp, dp)),
        (r"xattn/w[qkv]$",        (None, dp, mp)),
        (r"xattn/wo$",            (None, mp, dp)),
        # MLA factorizations
        (r"attn/wdq$",            (None, dp, mp)),
        (r"attn/wuq$",            (None, dp, mp)),
        (r"attn/wdkv$",           (None, dp, mp)),
        (r"attn/wukv$",           (None, dp, mp)),
        # SSM mixers
        (r"ssm/in_proj$",         (None, dp, mp)),
        (r"ssm/out_proj$",        (None, mp, dp)),
        (r"ssm/conv_w$",          (None, None, mp)),
        (r"ssm/conv_b$",          (None, mp)),
        # dense MLPs: [L, d, ff] / [L, ff, d]
        (r"mlp/w[gu]$",           (None, dp, mp)),
        (r"mlp/wd$",              (None, mp, dp)),
        (r"encoder/blocks/w[qkv]$", (None, dp, mp)),
        (r"encoder/blocks/wo$",   (None, mp, dp)),
        (r"encoder/blocks/mlp/w[gu]$", (None, dp, mp)),
        (r"encoder/blocks/mlp/wd$", (None, mp, dp)),
        (r"mtp_proj$",            (dp, mp)),
        # norms / scales / biases: replicated
        (r".*",                   None),
    ]


def _axes(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _fit(spec, shape, mesh) -> tuple:
    """``spec`` cut to the tensor's rank, each axis kept only where its
    mesh size divides the dim (small tensors replicate)."""
    fixed = []
    for i, ax in enumerate(spec[:len(shape)]):
        if ax is None:
            fixed.append(None)
            continue
        size = int(np.prod([axis_size(mesh, a) for a in _axes(ax)]))
        fixed.append(ax if shape[i] % size == 0 else None)
    return tuple(fixed)


def _map_leaves(fn, tree):
    """``fn(path, leaf)`` over a nested dict, structure kept."""
    return unflatten({k: fn(k, v) for k, v in flatten(tree).items()})


def param_specs(params, mesh, *, fsdp: bool = True):
    """The spec tree of a parameter tree (anything whose leaves have
    ``.shape``: tensors, meta tensors), over ``mesh`` (a ``DeviceMesh`` or
    a stand-in with a ``shape`` mapping)."""
    dp = "data" if fsdp else None
    rules = [(re.compile(pat), spec) for pat, spec in _rules(dp, "model")]

    def assign(path, leaf):
        for pat, spec in rules:
            if pat.search(path):
                return () if spec is None else _fit(spec, leaf.shape, mesh)
        return ()

    return _map_leaves(assign, params)


def placements(spec, mesh) -> tuple:
    """DTensor placements of a spec: for each mesh dim, ``Shard(d)`` where
    tensor dim ``d`` names that axis (alone or in a tuple), ``Replicate()``
    elsewhere and on a mesh dim of size 1 (a one-rank shard is the whole
    tensor; some torch releases' view rules refuse to merge or split a dim
    sharded even over one rank)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in axis_names(mesh):
        dims = [d for d, ax in enumerate(spec)
                if ax is not None and name in _axes(ax)]
        out.append(Shard(dims[0]) if dims and axis_size(mesh, name) > 1
                   else Replicate())
    return tuple(out)


def param_shardings(params, mesh, **kw):
    """The placements tree of :func:`param_specs`."""
    return _map_leaves(lambda _, s: placements(s, mesh),
                       param_specs(params, mesh, **kw))


def distribute(tree, mesh, shardings):
    """Every tensor leaf as a DTensor with its placements from
    ``shardings`` (same tree); the full tensor must be equal on every rank.
    Non-tensor leaves (a cache's ``step``) pass through."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    flat_s = flatten(shardings)
    return _map_leaves(
        lambda k, v: distribute_tensor(v, mesh, flat_s[k])
        if isinstance(v, torch.Tensor) else v, tree)


def undistribute(tree):
    """Every DTensor leaf as its full tensor (an all-gather)."""
    from torch.distributed.tensor import DTensor

    return _map_leaves(lambda _, v: v.full_tensor()
                       if isinstance(v, DTensor) else v, tree)


def batch_spec(mesh, seq_sharded: bool = False) -> tuple:
    """[B, S] token sharding: batch over (pod+)data; seq over model (SP)."""
    da = data_axes(mesh)
    da = da[0] if len(da) == 1 else da
    return (da, "model" if seq_sharded else None)


def cache_specs(cache, mesh, seq_axis_sharded: bool = True):
    """KV-cache specs for serving: batch over data when it divides,
    otherwise the sequence axis of the KV slabs over data (the
    flash-decode layout for long-context, B=1 cells); heads/latent over
    model when divisible, else the sequence over model."""
    da = data_axes(mesh)
    da = da[0] if len(da) == 1 else da
    dsize = int(np.prod([axis_size(mesh, a) for a in _axes(da)]))
    msize = axis_size(mesh, "model")

    def assign(path, leaf):
        if path.endswith("step"):
            return ()
        shape = leaf.shape
        if "ssm" in path:
            # [L,B,...] state: batch over data if divisible
            return (None, da) if shape[1] % dsize == 0 else ()
        # attention slabs [L, B, S, K, hd] or [L, B, S, latent]
        b_ok = shape[1] % dsize == 0
        spec = [None, da if b_ok else None, None]
        if len(shape) >= 4:
            heads_ok = shape[3] % msize == 0
            spec.append("model" if heads_ok else None)
            spec.extend([None] * (len(shape) - 4))
            if not heads_ok and seq_axis_sharded and shape[2] % msize == 0:
                spec[2] = "model"   # flash-decode: shard the sequence axis
        if not b_ok and seq_axis_sharded and spec[2] is None \
                and shape[2] % dsize == 0:
            spec[2] = da            # B=1 long-context: seq over data
        return tuple(spec)

    return _map_leaves(assign, cache)
