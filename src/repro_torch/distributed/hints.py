"""Activation sharding hints: redistribution that degrades to a no-op
off-mesh (the port of ``repro.distributed.hints``).

The model code calls ``hint(x, ("pod", "data"), None, "model")`` at the
places the reference anchors GSPMD (the post-embedding residual stream,
the unembedding logits, the MoE dispatch) and after each sublayer.  On a
DTensor it redistributes to the spec's placements; an axis the mesh lacks
or whose size does not divide the dim is dropped.  On a plain tensor, or
with no mesh registered, it is the identity, so the same model code runs
everywhere.

The other helpers stand where DTensor's op-by-op propagation has no
strategy, or a poor one, for what the model does; each is the identity on
plain tensors:

* ``fsdp_gather``: a block's weights all-gathered over the batch axes
  just in time (ZeRO-3);
* ``replicated``: an operand made ``Replicate()`` before an op DTensor
  cannot shard (the MoE capacity scatter and gather, the embedding);
* ``splittable``: a head split ``[..., H*hd] -> [..., H, hd]`` made legal
  when H does not divide the mesh dims sharding the last dim;
* ``pad``: ``F.pad`` on the local shard;
* ``local_heads`` / ``local_batch``: attention and the SSD scan run on
  each rank's batch (and head) shards, as ``shard_map`` would.
"""

from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.launch.mesh import axis_names, axis_size

_MESH = None


def set_mesh_hints(mesh) -> None:
    global _MESH
    _MESH = mesh


@contextlib.contextmanager
def mesh_hints(mesh):
    """Register ``mesh`` for the model code inside the block."""
    global _MESH
    old = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = old


def current_mesh():
    return _MESH


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def live_spec(shape, axes, mesh) -> tuple:
    """``axes`` (one entry per leading dim) with absent axes dropped and
    axes whose size does not divide the dim replaced by None."""
    names = set(axis_names(mesh))

    def live(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            t = tuple(b for b in a if b in names)
            return t if t else None
        return a if a in names else None

    fixed = []
    for i, a in enumerate(axes[:len(shape)]):
        a = live(a)
        if a is not None:
            size = int(np.prod([axis_size(mesh, b) for b in
                                (a if isinstance(a, tuple) else (a,))]))
            a = a if shape[i] % size == 0 else None
        fixed.append(a)
    return tuple(fixed)


def hint(x, *axes):
    """Redistribute a DTensor to the spec ``axes``; impossible axes are
    dropped.  The identity on a plain tensor or with no mesh."""
    if _MESH is None or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import placements

    want = placements(live_spec(x.shape, axes, _MESH), _MESH)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicated(x):
    """``x`` with every mesh dim ``Replicate()`` (a plain tensor passes
    through): for an op DTensor has no sharding strategy for."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def fsdp_gather(tree):
    """Every DTensor leaf of a parameter tree all-gathered over the batch
    axes (``pod``, ``data``), its ``model`` sharding kept: the just-in-time
    FSDP (ZeRO-3) gather before a layer runs.  Without it, DTensor's
    op-by-op propagation meets a weight sharded on its contracting dim and
    a batch-sharded activation by gathering the activation instead.  Its
    backward is the reduce-scatter of the gradient.  Plain leaves pass
    through."""
    from repro_torch.tree import tree_map

    return tree_map(_fsdp_gather_leaf, tree) if isinstance(tree, dict) \
        else _fsdp_gather_leaf(tree)


def _fsdp_gather_leaf(w):
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names or ()
    want = tuple(Replicate() if n in ("pod", "data") else pl
                 for n, pl in zip(names, w.placements))
    if tuple(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def splittable(x, dim: int, lead: int):
    """``x`` ready for dim ``dim`` to be split into (``lead``, rest), as a
    head split ``[..., H*hd] -> [..., H, hd]`` or ``[..., H] -> [..., K,
    rep]`` is.  DTensor cannot split a sharded dim unevenly (GSPMD pads):
    the mesh dims sharding ``dim`` are made ``Replicate()`` when their size
    does not divide ``lead``.  A plain tensor passes through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.ndim
    mesh = x.device_mesh
    on = [i for i, pl in enumerate(x.placements)
          if isinstance(pl, Shard) and pl.dim == dim]
    n = int(np.prod([mesh.size(i) for i in on])) if on else 1
    if lead % n == 0:
        return x
    want = [Replicate() if i in on else pl
            for i, pl in enumerate(x.placements)]
    return x.redistribute(mesh, want)


def pad(x, widths, value=0.0):
    """``F.pad(x, widths)``.  On a DTensor the pad runs on the local shard:
    some torch releases' DTensor rule for ``constant_pad_nd`` returns a
    spec with one placement on a multi-dim mesh, which the next view
    rejects.  A mesh dim sharding a padded dim is made ``Replicate()``
    first.  Differentiable."""
    import torch
    import torch.nn.functional as F

    if not is_dtensor(x):
        return F.pad(x, widths, value=value)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    want = [Replicate() if isinstance(pl, Shard) and pl.dim in padded
            else pl for pl in x.placements]
    if list(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    shape = list(x.shape)
    for i in range(0, len(widths), 2):
        shape[x.ndim - 1 - i // 2] += widths[i] + widths[i + 1]
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(F.pad(x.to_local(), widths, value=value),
                              x.device_mesh, want, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def on_ranks(mesh, pls) -> list:
    """``pls`` with ``Replicate()`` on every mesh dim of size 1 (see
    ``sharding.placements``)."""
    from torch.distributed.tensor import Replicate

    return [pl if mesh.size(i) > 1 else Replicate()
            for i, pl in enumerate(pls)]


def local_heads(fn, q, *kv, **kw):
    """``fn(q, *kv, **kw)`` on this rank's shards, for attention over
    [B, S, heads, dim] operands: the batch over the data axes where it
    divides, the heads over ``model`` where they divide it (when the KV
    heads do not, each KV head is first repeated for its query heads, as
    GSPMD does), replicated otherwise; the result ([B, S, H, dim]) in the
    same layout.  DTensor would otherwise propagate through every op of the
    blocked attention, and some torch releases cannot split a head dim
    sharded over ``model`` into (kv head, group) in the backward pass.
    Plain tensors call ``fn`` directly.  Differentiable."""
    if not is_dtensor(q):
        return fn(q, *kv, **kw)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    names = mesh.mesh_dim_names or ()
    n_dp = int(np.prod([mesh.size(i) for i, n in enumerate(names)
                        if n in ("pod", "data")]))
    m = mesh.size(names.index("model")) if "model" in names else 1
    H, K = q.shape[2], kv[0].shape[2]
    if K % m and H % m == 0:
        kv = tuple(t.repeat_interleave(H // K, dim=2) for t in kv)
        K = H
    pls = on_ranks(mesh, [
        Shard(0) if n in ("pod", "data") and q.shape[0] % n_dp == 0
        else Shard(2) if n == "model" and K % m == 0
        else Replicate() for n in names])
    loc = [t.redistribute(mesh, pls).to_local() for t in (q, *kv)]
    out = fn(*loc, **kw)
    return DTensor.from_local(out, mesh, pls, run_check=False)


def local_batch(fn, *args, **kw):
    """``fn(*args, **kw)`` on this rank's rows: every DTensor argument
    (batch-major, dim 0) redistributed to its batch over the data axes
    where it divides and replicated elsewhere, ``fn`` run on the local
    tensors, and each tensor it returns placed back the same way.  For a
    scan (the SSD) whose ops DTensor lacks strategies for in some torch
    releases (``cumsum``'s backward ``flip``).  Other arguments pass
    through; with no DTensor argument ``fn`` runs as it is.
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dts = [a for a in list(args) + list(kw.values()) if is_dtensor(a)]
    if not dts:
        return fn(*args, **kw)
    mesh = dts[0].device_mesh
    names = mesh.mesh_dim_names or ()
    n_dp = int(np.prod([mesh.size(i) for i, n in enumerate(names)
                        if n in ("pod", "data")]))
    pls = on_ranks(mesh, [
        Shard(0) if n in ("pod", "data") and dts[0].shape[0] % n_dp == 0
        else Replicate() for n in names])

    def loc(a):
        return a.redistribute(mesh, pls).to_local() if is_dtensor(a) else a

    out = fn(*[loc(a) for a in args], **{k: loc(v) for k, v in kw.items()})

    def back(t):
        return DTensor.from_local(t, mesh, pls, run_check=False)

    return tuple(map(back, out)) if isinstance(out, tuple) else back(out)


def as_dtensor(t, mesh):
    """``t`` as a DTensor on ``mesh``: a DTensor passes through, a plain
    tensor (equal on every rank) becomes a replicated one.
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
