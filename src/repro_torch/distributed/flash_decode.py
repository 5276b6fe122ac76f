"""Distributed flash-decode: one-token attention over a KV cache whose
SEQUENCE axis is sharded over the ``model`` mesh axis (the port of
``repro.distributed.flash_decode``).

Why: GQA serving caches are [B, S, K, hd].  When K (kv heads) does not
divide the model axis (nemotron-4: K=8 on a 16-way axis), the heads cannot
shard and the cache would be replicated over ``model``.  Sharding S instead
needs a distributed softmax, which sharding propagation does not invent;
this module writes it:

1. each model rank scores its local cache slice and computes the partial
   (row-max m, exp-sum l, weighted value acc), the flash-attention triple;
2. one ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` of [B,H] and
   [B,H,vd] tiles over the model group combine the partials exactly;
3. the new K/V is written by the one rank whose slice holds the slot, the
   port's clamped slot (``transformer._slot``): no traffic.

Masked scores are ``layers.NEG_INF`` (-1e30), never ``-inf``: a rank whose
slice is all masked has ``m_loc = -1e30``, and ``exp(m_loc - m_glob)`` is
then 0 (or 1 when every rank is masked), never NaN.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import hints
from repro_torch.distributed.hints import as_dtensor, on_ranks
from repro_torch.launch.mesh import axis_names, axis_size, data_axes
from repro_torch.models.layers import NEG_INF, _softcap, _window_eff


def seq_sharded_decode_applicable(mesh, B, Smax, K) -> bool:
    """Use the explicit path iff heads cannot shard but the sequence can."""
    if mesh is None or "model" not in axis_names(mesh):
        return False
    m = axis_size(mesh, "model")
    return K % m != 0 and Smax % m == 0


def _all_reduce(t, op: str, group):
    from torch.distributed._functional_collectives import (all_reduce,
                                                           wait_tensor)

    return wait_tensor(all_reduce(t, op, group))


@torch.no_grad()
def decode_attention_dist(q, k_cache, v_cache, k_new, v_new, pos: int, *,
                          window=0, softcap=0.0):
    """q [B,1,H,hd]; caches [B,Smax,K,*] seq-sharded over ``model``;
    k_new/v_new [B,1,K,*] this step's KV; pos: the write position (an
    int).  DTensors, or plain tensors equal on every rank.

    Returns (out [B,1,H,vd], new_k_cache, new_v_cache): DTensors with the
    cache's layout, or full tensors when the inputs were plain.  The caches
    passed in are left as they were.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = hints.current_mesh()
    B, Smax, K, vd = v_cache.shape
    H, hd = q.shape[2], q.shape[3]
    rep = H // K
    plain = not isinstance(k_cache, DTensor)
    names = axis_names(mesh)
    m_sz = axis_size(mesh, "model")
    S_loc = Smax // m_sz
    dp = data_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= axis_size(mesh, a)
    b_shard = B % n_dp == 0
    qs = on_ranks(mesh, [Shard(0) if a in dp and b_shard else Replicate()
                         for a in names])
    cs = on_ranks(mesh, [Shard(1) if a == "model" else Shard(0)
                         if a in dp and b_shard else Replicate()
                         for a in names])

    def local(t, pl):
        return as_dtensor(t, mesh).redistribute(mesh, pl).to_local()

    ql = local(q, qs)
    kc = local(k_cache, cs).clone()
    vc = local(v_cache, cs).clone()
    kn, vn = local(k_new, qs), local(v_new, qs)

    j = mesh.get_local_rank("model")
    slot = min(max(pos, 0), Smax - 1)
    li = slot - j * S_loc
    if 0 <= li < S_loc:
        kc[:, li] = kn[:, 0]
        vc[:, li] = vn[:, 0]

    b = ql.shape[0]
    qg = ql[:, 0].float().reshape(b, K, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, kc.float())
    s = _softcap(s.reshape(b, H, S_loc) * hd ** -0.5, softcap)
    gpos = j * S_loc + torch.arange(S_loc, device=ql.device)
    mask = (gpos <= pos) & (gpos > pos - _window_eff(int(window)))
    s = torch.where(mask, s, NEG_INF)

    m_loc = s.amax(dim=-1)                                  # [b,H]
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    acc = torch.einsum("bgrk,bkgd->bgrd", p.reshape(b, K, rep, S_loc),
                       vc.float()).reshape(b, H, vd)

    group = mesh.get_group("model")
    m_glob = _all_reduce(m_loc, "max", group)
    corr = torch.exp(m_loc - m_glob)
    l = _all_reduce(l_loc * corr, "sum", group)
    acc = _all_reduce(acc * corr[..., None], "sum", group)
    out = (acc / torch.clamp_min(l[..., None], 1e-30))[:, None].to(q.dtype)

    out, kc, vc = (DTensor.from_local(t, mesh, pl, run_check=False)
                   for t, pl in ((out, qs), (kc, cs), (vc, cs)))
    if plain:
        return out.full_tensor(), kc.full_tensor(), vc.full_tensor()
    return out, kc, vc
