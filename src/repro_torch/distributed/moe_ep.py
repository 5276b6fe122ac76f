"""Expert-parallel MoE dispatch with an explicit all-to-all (the port of
``repro.distributed.moe_ep``).

DTensor's sharding propagation has no strategy for the capacity scatter of
a MoE, so this module writes the production pattern by hand, as the
reference does inside ``shard_map``:

1. tokens are sharded over the batch axes; each model rank takes its
   1/n_mp slice of its data rank's tokens (the expert-sequence split, a
   ``Shard(0)`` over ``model`` too), so every rank routes T/(n_dp*n_mp)
   tokens;
2. each rank scatters its tokens into a send buffer laid out
   [n_mp destination ranks, E_loc, C2, d] and one **all-to-all over the
   model group** moves every token to the rank that owns its expert;
3. the expert FFNs run on [E_loc, n_mp*C2, d] with the FSDP-sharded
   weights all-gathered just in time over the data axes;
4. the reverse all-to-all, the local combine and an all-gather over model
   restore the token layout.

Every step is differentiable: the all-to-alls are the functional
``all_to_all_single_autograd`` (whose backward is the reverse
all-to-all), and the moves between layouts are DTensor
redistributions, whose backward DTensor derives.  A replicated operand
used with different tokens on each rank gets a ``Partial`` gradient
placement, so its gradient is summed over the ranks that used it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import hints
from repro_torch.distributed.hints import as_dtensor, on_ranks
from repro_torch.launch.mesh import axis_names, axis_size, data_axes


def _round8(x: int) -> int:
    return max(8, -(-x // 8) * 8)


def moe_block_ep(cfg, p, x, capacity_global: int):
    """Drop-in for ``layers.moe_block``: the EP path when a mesh with a
    ``model`` axis is registered and T, E and d divide; ``moe_block``
    otherwise (no mesh, decode-sized inputs).  ``x`` and ``p`` are
    DTensors or plain tensors equal on every rank; plain in, plain out."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.layers import mlp, moe_block, top_k

    mesh = hints.current_mesh()
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.topk
    T = B * S
    if mesh is None or "model" not in axis_names(mesh):
        return moe_block(cfg, p, x, capacity_global)
    dp = data_axes(mesh)
    n_dp = int(np.prod([axis_size(mesh, a) for a in dp]))
    n_mp = axis_size(mesh, "model")
    if T % (n_dp * n_mp) != 0 or E % n_mp != 0 or d % n_dp != 0:
        return moe_block(cfg, p, x, capacity_global)   # decode-sized inputs

    plain = not isinstance(x, DTensor)
    names = axis_names(mesh)
    T2 = T // (n_dp * n_mp)
    C2 = _round8(int(T2 * k / E * cfg.capacity_factor))
    E_loc = E // n_mp

    def on(axes_of):
        """One placement per mesh dim from a rule over the axis names."""
        return on_ranks(mesh, [axes_of(a) for a in names])

    tok_split = on(lambda a: Shard(0) if a in dp or a == "model"
                   else Replicate())
    tok_out = on(lambda a: Shard(0) if a in dp else Replicate())
    w_full = on(lambda a: Shard(0) if a == "model" else Replicate())
    w_grad = on(lambda a: Shard(0) if a == "model"
                else Partial() if a in dp else Replicate())

    xf = as_dtensor(x, mesh).reshape(T, d)
    # this rank's T2 tokens: data-major rows, then the model rank's slice
    xj = xf.redistribute(mesh, tok_split).to_local()
    # the router and the gathered expert weights are used with this rank's
    # tokens only: their gradients are partial sums over the ranks
    router = as_dtensor(p["router"], mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=on_ranks(mesh, [Partial()] * mesh.ndim))
    wg, wu, wd = (as_dtensor(p[n], mesh).redistribute(mesh, w_full)
                  .to_local(grad_placements=w_grad)
                  for n in ("wg", "wu", "wd"))

    scores = xj.float() @ router                                  # [T2,E]
    probs = (torch.sigmoid(scores) if cfg.router == "sigmoid"
             else torch.softmax(scores, dim=-1))
    gate_v, exp_i = top_k(probs, k)                               # [T2,k]
    gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)

    onehot = F.one_hot(exp_i.reshape(-1), E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    pos = pos.reshape(T2, k)
    keep = (pos >= 0) & (pos < C2)
    pos_c = pos.clamp(0, C2 - 1)

    send = xj.new_zeros((E, C2, d))
    for kk in range(k):
        upd = torch.where(keep[:, kk, None], xj, 0)
        send = send.index_put((exp_i[:, kk], pos_c[:, kk]), upd,
                              accumulate=True)

    # ---- all-to-all: token ranks -> expert ranks ----
    group = mesh.get_group("model")
    recv = _all_to_all(send.reshape(n_mp, E_loc, C2, d), group)
    work = recv.movedim(0, 1).reshape(E_loc, n_mp * C2, d)

    # ---- expert FFN on the just-in-time gathered weights ----
    h = F.silu(work @ wg) * (work @ wu)
    out = h @ wd                                      # [E_loc, n_mp*C2, d]

    # ---- reverse all-to-all: expert ranks -> token ranks ----
    back = out.reshape(E_loc, n_mp, C2, d).movedim(1, 0)
    ret = _all_to_all(back, group).reshape(E, C2, d)

    yj = torch.zeros_like(xj)
    for kk in range(k):
        got = ret[exp_i[:, kk], pos_c[:, kk]]                     # [T2,d]
        w = (keep[:, kk] * gate_v[:, kk]).to(xj.dtype)
        yj = yj + got * w[:, None]
    # all-gather over model: each data rank's T_loc rows again
    y = DTensor.from_local(yj, mesh, tok_split, run_check=False) \
        .redistribute(mesh, tok_out)

    if cfg.n_shared:
        shared = {n: as_dtensor(w, mesh) for n, w in p["shared"].items()}
        y = y + mlp(cfg, shared, xf)
    y = y.reshape(B, S, d)
    return y.full_tensor() if plain else y


def _all_to_all(t, group):
    """Differentiable all-to-all over ``group`` along dim 0 (one block per
    rank); its backward is the reverse all-to-all."""
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd, wait_tensor)

    return wait_tensor(all_to_all_single_autograd(t.contiguous(), None, None,
                                                  group))
