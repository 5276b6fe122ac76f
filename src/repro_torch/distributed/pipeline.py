"""Pipeline parallelism over the ``pod`` axis: a GPipe schedule (the port
of ``repro.distributed.pipeline``).

Opt-in (the default multipod layout keeps ``pod`` as outer data
parallelism): the layer-stacked block parameters are sharded over ``pod``
on the LAYER axis, so each pod holds a contiguous stage of L/n_stages
blocks; microbatches stream through the stages with a permute hand-off.
The schedule runs T = n_micro + n_stages - 1 ticks; tick t lets stage s
work on microbatch t - s (the GPipe trapezoid, bubble fraction
(n_stages-1)/T).

Differentiable end to end: the hand-off is :class:`_Permute`, whose
backward is the reverse permute; the last stage's emits are summed over the
axis by :class:`_SumReplicated`, whose backward passes the (replicated)
gradient through.  Every rank posts its send and receive in every tick,
valid or not, so the point-to-point calls always match.

``pipeline_forward`` takes the SAME stacked block tree the plain forward
uses, so any dense/ssm/hybrid config can be staged (MoE stages would also
reshard experts per stage — out of scope, as in the reference).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import hints
from repro_torch.distributed.hints import as_dtensor, on_ranks
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.tree import tree_map


def _p2p(send, to, recv_like, frm):
    """Send ``send`` to global rank ``to`` and receive a tensor like
    ``recv_like`` from global rank ``frm`` (either may be None); returns
    what came, or zeros."""
    out = torch.zeros_like(recv_like)
    ops = []
    if to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, out, frm))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


class _Permute(torch.autograd.Function):
    """Stage s sends to s+1 and receives from s-1 (zeros on stage 0);
    the backward sends the gradient to s-1 and receives from s+1."""

    @staticmethod
    def forward(ctx, x, nxt, prv):
        ctx.nxt, ctx.prv = nxt, prv
        return _p2p(x, nxt, x, prv)

    @staticmethod
    def backward(ctx, g):
        return _p2p(g, ctx.prv, g, ctx.nxt), None, None


class _SumReplicated(torch.autograd.Function):
    """All-reduce SUM over ``group`` into a value every rank holds; the
    loss reads the same value on every rank, so each rank's gradient is
    already the full one and passes through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        if dist.get_world_size(group) > 1:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_placements(mesh, axis, first):
    """``first`` on ``axis``, ``Replicate()`` on every other mesh dim."""
    from torch.distributed.tensor import Replicate

    return on_ranks(mesh, [first if a == axis else Replicate()
                           for a in axis_names(mesh)])


def pipeline_forward(cfg, params, tokens, *, n_micro: int,
                     axis: str = "pod"):
    """Decoder forward with blocks staged over ``axis`` of the registered
    mesh; returns the final-normed hidden state [B, S, d].

    ``params`` and ``tokens`` are DTensors or plain tensors equal on every
    rank; the embedding and the final norm are replicated per stage (cheap
    next to the stack), and the tokens replicated, as in the reference.
    Plain in, plain out; otherwise a replicated DTensor.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import layers as ll
    from repro_torch.models import transformer as T

    mesh = hints.current_mesh()
    if mesh is None or axis not in axis_names(mesh):
        raise ValueError(f"pipeline_forward needs a mesh with a {axis!r} "
                         "axis registered (hints.mesh_hints)")
    n_stages = axis_size(mesh, axis)
    blocks = params["blocks"]
    L = blocks["ln1"].shape[0]
    B, S = tokens.shape
    if L % n_stages or B % n_micro:
        raise ValueError(f"{L} layers over {n_stages} stages, batch {B} "
                         f"over {n_micro} microbatches: both must divide")
    plain = not isinstance(blocks["ln1"], DTensor)
    d = cfg.d_model
    mb = B // n_micro
    s = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    nxt = (dist.get_global_rank(group, s + 1) if s + 1 < n_stages
           else None)
    prv = dist.get_global_rank(group, s - 1) if s > 0 else None

    # the stage's own layers; every other axis sees the same computation,
    # so those gradients are replicated, and over `axis` the embedding's
    # gradient is stage 0's share of a sum
    stage = _stage_placements(mesh, axis, Shard(0))
    own = tree_map(lambda w: as_dtensor(w, mesh).redistribute(mesh, stage)
                   .to_local(), blocks)
    Ls = L // n_stages
    wins = T._windows(cfg, L)[s * Ls:(s + 1) * Ls]
    embed = as_dtensor(params["embed"], mesh).full_tensor()
    tok = as_dtensor(tokens, mesh).full_tensor()
    x = embed[tok]
    if cfg.embed_scale:
        x = T._scale_embed(cfg, x)
    x = as_dtensor(x, mesh).to_local(
        grad_placements=_stage_placements(mesh, axis, Partial()))
    positions = torch.arange(S, device=x.device).expand(mb, S)

    layers = T._unstack(own)
    micro_x = x.reshape(n_micro, mb, S, d)
    # tensor conditions, as the reference's jnp.where: every rank builds
    # the same graph, so its backward posts the same point-to-point calls
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == n_stages - 1, device=x.device)
    carry = torch.zeros((mb, S, d), dtype=x.dtype, device=x.device)
    emits = []
    for t in range(n_micro + n_stages - 1):
        recv = _Permute.apply(carry, nxt, prv)
        m = t - s
        valid = torch.tensor(0 <= m < n_micro, device=x.device)
        h = torch.where(first, micro_x[min(max(m, 0), n_micro - 1)], recv)
        for bp, w in zip(layers, wins):
            h = T._block_fwd(cfg, bp, h, positions, w, moe=False, capacity=0)
        carry = torch.where(valid, h, 0)
        if t >= n_stages - 1:
            # final-stage outputs live at ticks (n_stages-1) + m; every
            # other stage emits zeros, so a sum over the axis broadcasts
            emits.append(torch.where(last, carry, 0))
    y = _SumReplicated.apply(torch.cat(emits, dim=0), group)
    norm = as_dtensor(params["final_norm"], mesh).full_tensor()
    out = ll.rmsnorm(y.reshape(B, S, d), norm, cfg.norm_eps)
    if plain:
        return out
    return DTensor.from_local(out, mesh, _stage_placements(
        mesh, axis, Replicate()), run_check=False)
