"""Model building blocks in plain PyTorch: parameter trees, no framework.

Mirrors ``repro.models.layers`` function for function, so the same
parameter tree (nested dicts of tensors, layer parameters stacked on axis 0
as ``[L, ...]``) gives the same answers:

* norms, rope and softmax run in float32 and cast back; attention scores
  and ``p·v`` are float32 whatever the parameter dtype (the reference's
  ``preferred_element_type``), so bf16 operands are widened first;
* attention is the reference's blocked online softmax in plain torch: the
  same ``q_chunk``/``kv_chunk`` blocking, float32 (max, denominator,
  accumulator) carries and masks; no library attention;
* GQA query head ``h`` reads kv head ``h // rep`` (the reference's
  ``jnp.repeat(k, rep, axis=2)``), here by grouping the query heads rather
  than materialising the repeated keys;
* ``jax.nn.gelu`` is the tanh approximation, so ``gelu`` here is too.

Initialisation draws from one explicit ``torch.Generator`` (:class:`ParamInit`)
with the reference's shapes, dtypes and ``dense_init`` scales; it cannot
reproduce ``jax.random`` streams, so parity tests carry the reference's
weights across instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.hints import (hint, local_heads, replicated,
                                          splittable)

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


class ParamInit:
    """Where parameters are made and the stream they are drawn from.

    ``key`` is an int seed or a ``torch.Generator`` on ``device``.  On the
    ``meta`` device no values are drawn: only shapes and dtypes exist.
    """

    def __init__(self, device: torch.device, key=0):
        self.device = torch.device(device)
        if self.device.type == "meta":
            self.gen = None
        elif isinstance(key, torch.Generator):
            self.gen = key
        else:
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(key))

    def dense(self, shape, dtype, scale: float | None = None):
        """The reference's ``dense_init``: N(0, 1) * scale (fan_in ** -0.5
        unless given), drawn in float32 and cast to ``dtype``."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else fan_in ** -0.5
        if self.gen is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (x * scale).to(dtype)

    def zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype):
        return torch.ones(shape, dtype=dtype, device=self.device)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


def rope_angles(positions, head_dim, theta):
    """positions [...,S] -> cos/sin [...,S, head_dim//2] (f32)."""
    half = head_dim // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = theta ** (-ar / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin [..., S, hd//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def apply_mrope(x, positions3, theta, sections):
    """Qwen2-VL M-RoPE: three position streams rotate disjoint sections.

    x [B,S,H,hd]; positions3 [3,B,S]; sections: per-stream pair counts
    summing to hd//2 (text-only inputs pass identical streams).
    """
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    cs, ss = [], []
    off = 0
    for i, sec in enumerate(sections):
        ar = torch.arange(off, off + sec, dtype=torch.float32,
                          device=x.device)
        freqs = theta ** (-ar / half)
        ang = positions3[i].float()[..., None] * freqs
        cs.append(torch.cos(ang))
        ss.append(torch.sin(ang))
        off += sec
    return apply_rope(x, torch.cat(cs, dim=-1), torch.cat(ss, dim=-1))


# ---------------------------------------------------------------------------
# flash attention (plain torch, blocked, f32 accumulators)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _softcap(scores, cap):
    return torch.tanh(scores / cap) * cap if cap > 0 else scores


def _window_eff(window: int) -> int:
    """0 means unlimited."""
    return window if window > 0 else 2 ** 30


def flash_attention(q, k, v, **kw):
    """q [B,Sq,H,hd], k/v [B,Skv,K,hd or vd] (GQA: H % K == 0) -> [B,Sq,H,vd]
    (:func:`_flash_attention`; on a mesh, on each rank's batch and head
    shards)."""
    return local_heads(_flash_attention, q, k, v, **kw)


def _flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                     q_offset=0, q_chunk=512, kv_chunk=1024):
    """q [B,Sq,H,hd], k/v [B,Skv,K,hd or vd] (GQA: H % K == 0) -> [B,Sq,H,vd].

    window > 0 limits attention to the last ``window`` keys; q_offset
    shifts query positions.  Query blocks of ``q_chunk`` each run an online
    softmax over key blocks of ``kv_chunk`` (S padded up to whole blocks,
    padded keys masked), the reference's blocking and carries.
    """
    B, Sq, H, hd = q.shape
    _, Skv, K, vd = v.shape
    rep = H // K
    scale = hd ** -0.5
    w_eff = _window_eff(int(window))

    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    nq = -(-Sq // qc)
    nk = -(-Skv // kc)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * qc - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kc - Skv)).float()
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kc - Skv)).float()

    dev = q.device
    q_pos_base = torch.arange(qc, device=dev) + q_offset
    k_pos_base = torch.arange(kc, device=dev)

    outs = []
    for qi in range(nq):
        # query heads grouped by the kv head they read: [B, qc, K, rep, hd]
        qblk = qp[:, qi * qc:(qi + 1) * qc].float().reshape(B, qc, K, rep, hd)
        q_pos = q_pos_base + qi * qc
        m = torch.full((B, H, qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, qc, vd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kblk = kp[:, ki * kc:(ki + 1) * kc]
            vblk = vp[:, ki * kc:(ki + 1) * kc]
            k_pos = k_pos_base + ki * kc
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kblk)
            s = s.reshape(B, H, qc, kc) * scale
            s = _softcap(s, softcap)
            mask = (k_pos < Skv)[None, :].expand(qc, kc)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            mask = mask & (q_pos[:, None] - k_pos[None, :] < w_eff)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            pv = torch.einsum("bgrqk,bkgd->bgrqd",
                              p.reshape(B, K, rep, qc, kc), vblk)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + pv.reshape(B, H, qc, vd)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.movedim(1, 2))             # [B, qc, H, vd]
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len, *, window=0, softcap=0.0):
    """Single-position attention against a prefilled cache.

    q [B,1,H,hd]; k_cache/v_cache [B,Smax,K,*]; cur_len: #valid cache slots
    (the new token's position is cur_len-1), an int.  On a mesh, on each
    rank's batch and head shards.
    """
    return local_heads(_decode_attention, q, k_cache, v_cache,
                       cur_len=cur_len, window=window, softcap=softcap)


def _decode_attention(q, k_cache, v_cache, cur_len, *, window=0,
                      softcap=0.0):
    B, Smax, K, vd = v_cache.shape
    H = q.shape[2]
    rep = H // K
    scale = q.shape[-1] ** -0.5
    qg = q[:, 0].float().reshape(B, K, rep, q.shape[-1])
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache.float())
    s = _softcap(s.reshape(B, H, Smax) * scale, softcap)
    pos = torch.arange(Smax, device=q.device)
    mask = (pos < cur_len) & (pos > cur_len - 1 - _window_eff(int(window)))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.reshape(B, K, rep, Smax),
                       v_cache.float())
    return out.reshape(B, 1, H, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(cfg, init: ParamInit, L, dtype):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = dict(
        wq=init.dense((L, d, H * hd), dtype),
        wk=init.dense((L, d, K * hd), dtype),
        wv=init.dense((L, d, K * hd), dtype),
        wo=init.dense((L, H * hd, d), dtype),
    )
    if cfg.qk_norm:
        p["q_scale"] = init.zeros((L, hd), dtype)
        p["k_scale"] = init.zeros((L, hd), dtype)
    return p


def mrope_sections(hd: int) -> tuple:
    """The three M-RoPE sections (pair counts) of a head of ``hd``."""
    half = hd // 2
    return (half // 4, half - half // 4 - (half - half // 4) // 2,
            (half - half // 4) // 2)


def gqa_qkv(cfg, p, x, positions):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,K,hd] with rope applied."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = splittable(x @ p["wq"], -1, H).reshape(B, S, H, hd)
    k = splittable(x @ p["wk"], -1, K).reshape(B, S, K, hd)
    v = splittable(x @ p["wv"], -1, K).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_scale"], cfg.norm_eps)
        k = rmsnorm(k, p["k_scale"], cfg.norm_eps)
    if cfg.rope == "rope":
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    elif cfg.rope == "mrope":
        sec = mrope_sections(hd)
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, pos3, cfg.rope_theta, sec)
        k = apply_mrope(k, pos3, cfg.rope_theta, sec)
    return q, k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(cfg, init: ParamInit, L, dtype):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return dict(
        wdq=init.dense((L, d, m.q_lora_rank), dtype),
        q_norm=init.zeros((L, m.q_lora_rank), dtype),
        wuq=init.dense((L, m.q_lora_rank, H * qk), dtype),
        wdkv=init.dense((L, d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
        kv_norm=init.zeros((L, m.kv_lora_rank), dtype),
        wukv=init.dense((L, m.kv_lora_rank,
                         H * (m.qk_nope_head_dim + m.v_head_dim)), dtype),
        wo=init.dense((L, H * m.v_head_dim, d), dtype),
    )


def mla_qkv(cfg, p, x, positions):
    """Returns q [B,S,H,qk], k [B,S,H,qk], v [B,S,H,vd]."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    q = splittable(q, -1, H).reshape(B, S, H, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    dkv = x @ p["wdkv"]
    c = rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:].reshape(B, S, 1, rope_d)

    cos, sin = rope_angles(positions, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    ukv = splittable(c @ p["wukv"], -1, H).reshape(B, S, H, nope + vd)
    k_nope, v = ukv[..., :nope], ukv[..., nope:]
    k = torch.cat([k_nope, k_rope.expand(q_rope.shape)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(cfg, init: ParamInit, L, dtype, d_ff=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if "glu" in cfg.act:
        return dict(wg=init.dense((L, d, ff), dtype),
                    wu=init.dense((L, d, ff), dtype),
                    wd=init.dense((L, ff, d), dtype))
    return dict(wu=init.dense((L, d, ff), dtype),
                wd=init.dense((L, ff, d), dtype))


def mlp(cfg, p, x):
    if cfg.act == "silu_glu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.act == "gelu_glu":
        return (gelu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.act == "gelu":
        return gelu(x @ p["wu"]) @ p["wd"]
    if cfg.act == "relu2":
        h = torch.relu(x @ p["wu"])
        return (h * h) @ p["wd"]
    raise ValueError(cfg.act)


# ---------------------------------------------------------------------------
# MoE (capacity-based dispatch)
# ---------------------------------------------------------------------------

def init_moe(cfg, init: ParamInit, L, dtype):
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = dict(
        router=init.dense((L, d, E), torch.float32, scale=0.02),
        wg=init.dense((L, E, d, ff), dtype),
        wu=init.dense((L, E, d, ff), dtype),
        wd=init.dense((L, E, ff, d), dtype),
    )
    if cfg.n_shared:
        p["shared"] = init_mlp(cfg, init, L, dtype,
                               d_ff=cfg.moe_d_ff * cfg.n_shared)
    return p


def top_k(x, k: int):
    """``lax.top_k`` over the last axis: the k largest, equal values in
    index order (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_block(cfg, p, x, capacity: int):
    """x [B,S,d] -> [B,S,d].  Top-k routing with static per-expert capacity.

    Slots are assigned token-major over the flattened [T*k] queue; an
    expert's tokens past ``capacity`` are dropped (their scatter adds zero
    to the last slot and their gather weight is zero), the shared expert
    covering every token.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.topk
    T = B * S
    xf = hint(x.reshape(T, d), ("pod", "data"), None)
    # the routing sort, the capacity scatter (index_put_) and the combine
    # gather have no DTensor sharding strategy: on a mesh they run on
    # replicated operands (plain tensors pass through)
    xr = replicated(xf)

    scores = xr.float() @ replicated(p["router"])              # [T, E]
    if cfg.router == "sigmoid":
        probs = torch.sigmoid(scores)
    else:
        probs = torch.softmax(scores, dim=-1)
    gate_v, exp_i = top_k(probs, k)                            # [T, k]
    gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True), 1e-9)

    flat_e = exp_i.reshape(-1)
    onehot = F.one_hot(flat_e, E).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    pos = pos.reshape(T, k)
    keep = (pos >= 0) & (pos < capacity)
    pos_c = pos.clamp(0, capacity - 1)

    buf = xr.new_zeros((E, capacity, d))
    for j in range(k):
        upd = torch.where(keep[:, j, None], xr, 0)
        buf = buf.index_put((exp_i[:, j], pos_c[:, j]), upd, accumulate=True)
    buf = hint(buf, "model", ("pod", "data"), None)

    h = F.silu(buf @ p["wg"]) * (buf @ p["wu"])                # [E, C, ff]
    h = hint(h, "model", ("pod", "data"), None)
    out_buf = replicated(h @ p["wd"])                          # [E, C, d]

    y = torch.zeros_like(xr)
    for j in range(k):
        got = out_buf[exp_i[:, j], pos_c[:, j]]                # [T, d]
        w = (keep[:, j] * gate_v[:, j]).to(xr.dtype)
        y = y + got * w[:, None]
    y = hint(y, ("pod", "data"), None)

    if cfg.n_shared:
        y = y + mlp(cfg, p["shared"], xf)
    return y.reshape(B, S, d)
