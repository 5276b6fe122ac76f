"""Unified decoder LM + enc-dec — one code path for all 10 architectures,
the serving part of ``repro.models.transformer`` in plain PyTorch.

Parameters are a nested dict of tensors with the reference's key paths and
stacked layout, so a reference pytree converts leaf by leaf
(:func:`params_from_numpy`):

* ``dense_blocks`` — the leading ``n_dense_layers`` blocks of MoE configs
  (DeepSeek's first 3 layers are dense);
* ``blocks`` — the remaining homogeneous blocks, stacked on axis 0 as
  ``[L, ...]`` and run by a Python loop over layers (the reference scans).
  Gemma's local/global alternation is the per-layer window list
  (:func:`_windows`);
* families: dense/moe/vlm -> attention blocks; ssm -> mamba2 mixer blocks;
  hybrid -> parallel attention + mamba2 heads sharing the block input
  (Hymba); audio -> whisper-style encoder + cross-attention decoder.

Entry points: ``init_params``, ``forward``/``prefill``/``encode``,
``init_cache`` + ``decode_step`` (serving), :class:`TransformerLM` (the
same tree registered as ``nn.Parameter``s under the reference's dotted
paths).  Entry points that make tensors default to the card and raise
without one; tests pass ``device="cpu"``.

The cache's ``step`` is a Python int, so a decode step reads nothing back
from the device.  ``decode_step`` leaves its input cache as it was: the
slabs it writes are copied once a step, each layer then writing its slot
into the copy.  A step at ``pos >= max_len`` writes the last slot, as the
reference's clamped ``dynamic_update_slice`` does.

Training: ``loss_fn`` (next-token CE over ``_chunked_ce``'s ``ce_chunk``
slices, plus DeepSeek's MTP loss at weight 0.3) and ``mtp_logits``.  While
grad is enabled, ``cfg.remat`` checkpoints each block of ``blocks`` (and
``"full"`` each encoder block) with ``torch.utils.checkpoint``, and every
CE chunk is checkpointed; with grad off (prefill, decode) the same ops run
without it.  A stacked group is split into per-layer views with one
``unbind`` a leaf, so a backward pass stacks each leaf's gradient once.
Still left for the distributed slice: the reference's sharding hints,
``moe_block_ep`` (``moe_block`` stands in, as the reference falls back to
it without a mesh) and the sequence-sharded decode.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.packed import resolve_device
from repro_torch.tree import tree_map

from . import layers as ll
from . import ssm as ssm_mod
from .config import ModelConfig

# leaves the reference keeps in float32 whatever the parameter dtype
F32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D", "state"})
# cross-attention slabs: made once by init_cache, never written by a step
_READ_ONLY = frozenset({"xk", "xv"})


def _layer(tree, l: int):
    return tree_map(lambda a: a[l], tree)


def _unstack(tree) -> list:
    """Per-layer views of a stacked ``[L, ...]`` group, one ``unbind`` a
    leaf (its backward stacks the layers' gradients once; indexing each
    layer would scatter L full-size gradients)."""
    per: list = []
    for k, v in tree.items():
        parts = _unstack(v) if isinstance(v, dict) else v.unbind(0)
        if not per:
            per = [{} for _ in parts]
        for layer, part in zip(per, parts):
            layer[k] = part
    return per


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block_group(cfg: ModelConfig, init, L: int, dtype, moe: bool):
    """One stacked group of L identical blocks."""
    p = {"ln1": init.zeros((L, cfg.d_model), dtype),
         "ln2": init.zeros((L, cfg.d_model), dtype)}
    if cfg.attn == "gqa":
        p["attn"] = ll.init_gqa(cfg, init, L, dtype)
    elif cfg.attn == "mla":
        p["attn"] = ll.init_mla(cfg, init, L, dtype)
    if cfg.ssm is not None:
        p["ssm"] = ssm_mod.init_ssm(cfg, init, L, dtype)
    if moe:
        p["moe"] = ll.init_moe(cfg, init, L, dtype)
    elif cfg.d_ff > 0:
        p["mlp"] = ll.init_mlp(cfg, init, L, dtype)
    if cfg.encdec:
        d = cfg.d_model
        p["xattn"] = dict(
            wq=init.dense((L, d, cfg.n_heads * cfg.head_dim), dtype),
            wk=init.dense((L, d, cfg.n_kv_heads * cfg.head_dim), dtype),
            wv=init.dense((L, d, cfg.n_kv_heads * cfg.head_dim), dtype),
            wo=init.dense((L, cfg.n_heads * cfg.head_dim, d), dtype),
        )
        p["lnx"] = init.zeros((L, d), dtype)
    return p


def init_params(cfg: ModelConfig, key=0, dtype=torch.bfloat16,
                device="cuda"):
    """Random parameters with the reference's tree, shapes, dtypes and
    ``dense_init`` scales.  ``key``: an int seed or a ``torch.Generator`` on
    ``device``; ``device="meta"`` makes shapes only."""
    init = ll.ParamInit(resolve_device(device), key)
    params = {
        "embed": init.dense((cfg.vocab, cfg.d_model), dtype, scale=1.0),
        "final_norm": init.zeros((cfg.d_model,), dtype),
    }
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    n_plain = cfg.n_layers - n_moe
    if cfg.moe:
        if n_plain:
            params["dense_blocks"] = _init_block_group(
                cfg, init, n_plain, dtype, moe=False)
        params["blocks"] = _init_block_group(cfg, init, n_moe, dtype,
                                             moe=True)
    else:
        params["blocks"] = _init_block_group(
            cfg, init, cfg.n_layers, dtype, moe=False)
    if not cfg.tie_embeddings:
        params["unembed"] = init.dense((cfg.d_model, cfg.vocab), dtype)
    if cfg.mtp:
        params["mtp_proj"] = init.dense((2 * cfg.d_model, cfg.d_model),
                                        dtype)
        params["mtp_block"] = _init_block_group(cfg, init, 1, dtype,
                                                moe=False)
    if cfg.encdec:
        params["encoder"] = {
            "blocks": _init_encoder_blocks(cfg, init, dtype),
            "norm": init.zeros((cfg.d_model,), dtype),
        }
    return params


def _init_encoder_blocks(cfg, init, dtype):
    d = cfg.d_model
    L = cfg.enc_layers
    return dict(
        ln1=init.zeros((L, d), dtype), ln2=init.zeros((L, d), dtype),
        wq=init.dense((L, d, cfg.n_heads * cfg.head_dim), dtype),
        wk=init.dense((L, d, cfg.n_heads * cfg.head_dim), dtype),
        wv=init.dense((L, d, cfg.n_heads * cfg.head_dim), dtype),
        wo=init.dense((L, cfg.n_heads * cfg.head_dim, d), dtype),
        mlp=ll.init_mlp(dataclasses.replace(cfg, act="gelu"), init, L,
                        dtype),
    )


def _from_numpy(tree, dev, dtype):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _from_numpy(v, dev, dtype)
            continue
        t = torch.from_numpy(np.array(v)).to(dev)
        if dtype is not None and t.is_floating_point() and \
                k not in F32_LEAVES:
            t = t.to(dtype)
        out[k] = t
    return out


def params_from_numpy(tree, device="cuda", dtype=None):
    """The reference's parameter pytree, as nested dicts of numpy arrays,
    as the port's.  ``dtype`` casts the floating leaves the reference makes
    in the parameter dtype (not the float32 ones: the router, ``A_log``,
    ``dt_bias``, ``D``); None keeps each array's dtype."""
    return _from_numpy(tree, resolve_device(device), dtype)


def cache_from_numpy(tree, device="cuda", dtype=None):
    """The reference's cache pytree, as nested dicts of numpy arrays, as
    the port's: ``step`` a Python int, ``dtype`` as in
    :func:`params_from_numpy` (the SSD ``state`` stays float32)."""
    rest = {k: v for k, v in tree.items() if k != "step"}
    out = _from_numpy(rest, resolve_device(device), dtype)
    out["step"] = int(np.asarray(tree["step"]))
    return out


def to_device(tree, device):
    """A params or cache tree on ``device`` (ints pass through)."""
    dev = resolve_device(device)
    return tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                    else a, tree)


def _windows(cfg: ModelConfig, L: int, offset: int = 0) -> list:
    """Per-layer sliding-window list (0 = full attention)."""
    return [0 if cfg.layer_is_global(l + offset) else cfg.local_window
            for l in range(L)]


def _scale_embed(cfg, x):
    """``x * sqrt(d_model)`` with the scale rounded to x's dtype first, as
    the reference's ``jnp.asarray(d_model ** 0.5, x.dtype)``."""
    s = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x * s


# ---------------------------------------------------------------------------
# blocks (shared by forward and decode)
# ---------------------------------------------------------------------------

def _attn_full(cfg, p, x, positions, window):
    if cfg.attn == "mla":
        q, k, v = ll.mla_qkv(cfg, p, x, positions)
    else:
        q, k, v = ll.gqa_qkv(cfg, p, x, positions)
    o = ll.flash_attention(q, k, v, causal=True, window=window,
                           softcap=cfg.softcap_attn,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


def _xattn_full(cfg, p, x, enc_out):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (enc_out @ p["wk"]).reshape(B, enc_out.shape[1], K, hd)
    v = (enc_out @ p["wv"]).reshape(B, enc_out.shape[1], K, hd)
    o = ll.flash_attention(q, k, v, causal=False, window=0,
                           q_chunk=cfg.attn_q_chunk,
                           kv_chunk=cfg.attn_kv_chunk)
    return o.reshape(B, S, -1) @ p["wo"]


def _mixers(attn_out, ssm_out):
    """The block's mixer sum: attention, SSM, or Hymba's mean of both."""
    if attn_out is None:
        return ssm_out
    if ssm_out is None:
        return attn_out
    return (attn_out + ssm_out) * 0.5


def _block_fwd(cfg: ModelConfig, p, x, positions, window, moe: bool,
               capacity: int, enc_out=None):
    h = ll.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = _attn_full(cfg, p["attn"], h, positions, window) \
        if "attn" in p else None
    s = ssm_mod.ssm_forward(cfg, p["ssm"], h)[0] if "ssm" in p else None
    x = x + _mixers(a, s)
    if "xattn" in p:
        hx = ll.rmsnorm(x, p["lnx"], cfg.norm_eps)
        x = x + _xattn_full(cfg, p["xattn"], hx, enc_out)
    if moe:
        h2 = ll.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + ll.moe_block(cfg, p["moe"], h2, capacity)
    elif "mlp" in p:
        h2 = ll.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + ll.mlp(cfg, p["mlp"], h2)
    return x


# matmuls with no batch dims (``x @ w`` folds to aten.mm): what jax's
# dots_with_no_batch_dims_saveable keeps for the backward pass
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(body, policy=None):
    """``body`` under activation checkpointing while grad is enabled (a
    backward pass will need it); as it is otherwise.  ``policy``: a
    selective-checkpoint policy, None to save only the inputs."""
    kw = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def _remat(cfg: ModelConfig, body):
    """Activation-checkpoint policy for the block stack.

    'full'  — save only the block's input; recompute everything;
    'dots'  — save the matmul outputs with no batch dims: the backward
              skips recomputing them;
    'none'  — no checkpointing.
    """
    if cfg.remat == "full":
        return _checkpointed(body)
    if cfg.remat == "dots":
        return _checkpointed(body, _save_dots)
    return body


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    if not cfg.moe:
        return 0
    c = int(n_tokens * cfg.topk / cfg.n_experts * cfg.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params, enc_frames):
    """Whisper-style encoder over precomputed frame embeddings (the conv
    downsampling frontend is upstream)."""
    eb = params["encoder"]["blocks"]
    B, S, d = enc_frames.shape
    dev = enc_frames.device
    pos = torch.arange(S, device=dev)
    half = d // 2
    freqs = 10000 ** (-torch.arange(half, dtype=torch.float32, device=dev)
                      / half)
    pe = torch.cat([torch.sin(pos[:, None] * freqs),
                    torch.cos(pos[:, None] * freqs)], dim=1)
    x = enc_frames + pe[None].to(enc_frames.dtype)
    c2 = dataclasses.replace(cfg, act="gelu")
    H, hd = cfg.n_heads, cfg.head_dim

    def enc_block(x, bp):
        h = ll.rmsnorm(x, bp["ln1"], cfg.norm_eps)
        q = (h @ bp["wq"]).reshape(B, S, H, hd)
        k = (h @ bp["wk"]).reshape(B, S, H, hd)
        v = (h @ bp["wv"]).reshape(B, S, H, hd)
        o = ll.flash_attention(q, k, v, causal=False, window=0,
                               q_chunk=cfg.attn_q_chunk,
                               kv_chunk=cfg.attn_kv_chunk)
        x = x + o.reshape(B, S, -1) @ bp["wo"]
        h2 = ll.rmsnorm(x, bp["ln2"], cfg.norm_eps)
        return x + ll.mlp(c2, bp["mlp"], h2)

    # the reference checkpoints its scanned encoder under "full" only
    if cfg.remat == "full" and not cfg.unroll_layers:
        enc_block = _checkpointed(enc_block)
    for bp in _unstack(eb):
        x = enc_block(x, bp)
    return ll.rmsnorm(x, params["encoder"]["norm"], cfg.norm_eps)


def _trunk(cfg: ModelConfig, params, tokens, enc_frames, positions, embeds):
    """The block stack: tokens [B,S] -> the hidden state before the final
    norm."""
    B, S = tokens.shape
    x = params["embed"][tokens] if embeds is None else embeds
    if cfg.embed_scale:
        x = _scale_embed(cfg, x)
    positions = (torch.arange(S, device=x.device).expand(B, S)
                 if positions is None else positions)
    enc_out = encode(cfg, params, enc_frames) if cfg.encdec else None
    cap = _capacity(cfg, B * S)

    off = 0
    if "dense_blocks" in params:
        db = _unstack(params["dense_blocks"])
        off = len(db)
        for l, bp in enumerate(db):
            x = _block_fwd(cfg, bp, x, positions, _windows(cfg, 1, l)[0],
                           moe=False, capacity=0, enc_out=enc_out)

    def body(x, bp, w):
        return _block_fwd(cfg, bp, x, positions, w, moe=cfg.moe,
                          capacity=cap, enc_out=enc_out)

    bfn = _remat(cfg, body)
    blocks = _unstack(params["blocks"])
    for bp, w in zip(blocks, _windows(cfg, len(blocks), off)):
        x = bfn(x, bp, w)
    return x


def forward(cfg: ModelConfig, params, tokens, enc_frames=None,
            positions=None, embeds=None, return_hidden=False):
    """tokens [B,S] -> logits [B,S,V] (float32).  enc_frames for enc-dec
    configs; ``embeds`` overrides the token embedding (VLM patch-stub
    path).  ``return_hidden`` also returns the pre-norm hidden state."""
    x = _trunk(cfg, params, tokens, enc_frames, positions, embeds)
    xn = ll.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, xn)
    return (logits, x) if return_hidden else logits


def forward_hidden(cfg: ModelConfig, params, tokens, enc_frames=None,
                   positions=None, embeds=None):
    """Like ``forward`` but stops at the final-normed hidden state (no
    [B, S, V] logits tensor is made)."""
    x = _trunk(cfg, params, tokens, enc_frames, positions, embeds)
    return ll.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def prefill(cfg: ModelConfig, params, tokens, enc_frames=None):
    """Serving prefill: run the stack over the prompt, emit ONLY the
    last-position logits (what a decode loop consumes)."""
    h = forward_hidden(cfg, params, tokens, enc_frames=enc_frames)
    return _unembed(cfg, params, h[:, -1:])


def _unembed(cfg, params, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).float()
    if cfg.softcap_logits > 0:
        logits = torch.tanh(logits / cfg.softcap_logits) * cfg.softcap_logits
    return logits


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def _chunked_ce(cfg, params, hidden, targets, mask):
    """Mean CE over valid targets, computed in ``ce_chunk``-token slices,
    each checkpointed while grad is enabled, so one [B, chunk, V] float32
    logits tile is the only vocab-sized live tensor; the backward pass
    recomputes it.  S is padded to whole chunks with mask 0."""
    B, S, d = hidden.shape
    c = min(cfg.ce_chunk, S)
    pad = (-S) % c
    h = F.pad(hidden, (0, 0, 0, pad))
    t = F.pad(targets, (0, pad)).long()
    m = F.pad(mask, (0, pad))

    def body(hc, tc, mc):
        lp = torch.log_softmax(_unembed(cfg, params, hc), dim=-1)
        nll = -torch.gather(lp, -1, tc[..., None])[..., 0]
        return torch.sum(nll * mc)

    chunk = _checkpointed(body)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S + pad, c):
        total = total + chunk(h[:, i:i + c], t[:, i:i + c], m[:, i:i + c])
    return total / torch.clamp(mask.sum(), min=1)


def _mtp_hidden(cfg, params, hidden, tokens):
    """DeepSeek's depth-1 MTP block over [h_t ; emb(t+1)], final-normed:
    [B, S-1, d] aligned to targets shifted by 2."""
    B, S = tokens.shape
    emb_next = params["embed"][tokens[:, 1:]]              # [B,S-1,d]
    h = torch.cat([hidden[:, :-1], emb_next], dim=-1) @ params["mtp_proj"]
    bp = _layer(params["mtp_block"], 0)
    pos = torch.arange(S - 1, device=h.device).expand(B, S - 1)
    h = _block_fwd(cfg, bp, h, pos, 0, moe=False, capacity=0)
    return ll.rmsnorm(h, params["final_norm"], cfg.norm_eps)


def mtp_logits(cfg: ModelConfig, params, hidden, tokens):
    """DeepSeek MTP head: depth-1 extra block predicting token t+2 from
    [h_t ; emb(t+1)]; ``hidden`` is the pre-norm trunk output.  Returns
    logits aligned to targets shifted by 2."""
    return _unembed(cfg, params, _mtp_hidden(cfg, params, hidden, tokens))


def loss_fn(cfg: ModelConfig, params, tokens, enc_frames=None,
            mtp_weight: float = 0.3):
    """Next-token CE (+ DeepSeek's MTP auxiliary loss when configured),
    through the chunked CE: no [B, S, V] logits tensor is made."""
    hidden = _trunk(cfg, params, tokens, enc_frames, None, None)
    hn = ll.rmsnorm(hidden, params["final_norm"], cfg.norm_eps)
    tgt = tokens[:, 1:]
    mask = torch.ones(tgt.shape, dtype=torch.float32, device=tgt.device)
    loss = _chunked_ce(cfg, params, hn[:, :-1], tgt, mask)
    if cfg.mtp:
        h2 = _mtp_hidden(cfg, params, hidden, tokens)
        tgt2 = tokens[:, 2:]
        m2 = torch.ones(tgt2.shape, dtype=torch.float32, device=tgt2.device)
        loss = loss + mtp_weight * _chunked_ce(cfg, params, h2[:, :-1],
                                               tgt2, m2)
    return loss


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_out=None, params=None,
               device="cuda"):
    """Stacked per-layer cache tree sized for ``max_len`` positions; enc-dec
    configs fill their cross-attention slabs from ``enc_out``."""
    dev = resolve_device(device)
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    n_plain = cfg.n_layers - n_moe

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(L):
        if cfg.attn == "mla":
            m = cfg.mla
            return dict(c=zeros((L, batch, max_len, m.kv_lora_rank)),
                        k_rope=zeros((L, batch, max_len,
                                      m.qk_rope_head_dim)))
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return dict(k=zeros(shape), v=zeros(shape))

    def ssm_cache(L):
        s = cfg.ssm
        conv_ch = s.n_heads * s.head_dim + 2 * s.state_dim
        return dict(
            conv=zeros((L, batch, s.conv_width - 1, conv_ch)),
            state=zeros((L, batch, s.n_heads, s.state_dim, s.head_dim),
                        torch.float32))

    def group_cache(L):
        c = {}
        if cfg.attn != "none":
            c["attn"] = attn_cache(L)
        if cfg.ssm is not None:
            c["ssm"] = ssm_cache(L)
        if cfg.encdec:
            assert enc_out is not None and params is not None
            eb = params["blocks"]["xattn"]
            e = enc_out.to(dev)
            Se = e.shape[1]
            K, hd = cfg.n_kv_heads, cfg.head_dim
            for name, w in (("xk", eb["wk"]), ("xv", eb["wv"])):
                dt = torch.promote_types(e.dtype, w.dtype)
                kv = torch.einsum("bsd,ldk->lbsk", e.to(dt), w.to(dev, dt))
                c[name] = kv.reshape(L, batch, Se, K, hd)
        return c

    cache = {"step": 0}
    if n_plain and cfg.moe:
        cache["dense"] = group_cache(n_plain)
        cache["main"] = group_cache(n_moe)
    else:
        cache["main"] = group_cache(cfg.n_layers if not cfg.moe else n_moe)
    return cache


def _slot(pos: int, max_len: int) -> int:
    """The write position of ``dynamic_update_slice_in_dim``: the start
    index clamped into the slab, so a step past ``max_len`` overwrites the
    last slot."""
    return min(max(pos, 0), max_len - 1)


def _attn_decode(cfg, p, h, cache_l, pos, window):
    """h [B,1,d]; writes this step's K/V into the layer's slabs (the
    step's own copy) and returns the attention output."""
    if cfg.attn == "mla":
        return _mla_decode(cfg, p, h, cache_l, pos)
    B = h.shape[0]
    posv = torch.full((B, 1), pos, device=h.device)
    q, k, v = ll.gqa_qkv(cfg, p, h, posv)
    kc, vc = cache_l["k"], cache_l["v"]
    slot = _slot(pos, kc.shape[1])
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    o = ll.decode_attention(q, kc, vc, pos + 1, window=window,
                            softcap=cfg.softcap_attn)
    return o.reshape(B, 1, -1) @ p["wo"]


def _mla_decode(cfg, p, h, cache_l, pos):
    """Absorbed-matrix MLA decode: attention runs in the latent space, the
    cache stores only (c, k_rope)."""
    m = cfg.mla
    B = h.shape[0]
    H = cfg.n_heads
    nope, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    posv = torch.full((B, 1), pos, device=h.device)

    q = ll.rmsnorm(h @ p["wdq"], p["q_norm"], cfg.norm_eps) @ p["wuq"]
    q = q.reshape(B, 1, H, nope + rd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = ll.rope_angles(posv, rd, cfg.rope_theta)
    q_rope = ll.apply_rope(q_rope, cos, sin)

    dkv = h @ p["wdkv"]
    c_new = ll.rmsnorm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope_new = ll.apply_rope(
        dkv[..., m.kv_lora_rank:].reshape(B, 1, 1, rd), cos, sin
    ).reshape(B, 1, rd)

    cc, kr = cache_l["c"], cache_l["k_rope"]
    slot = _slot(pos, cc.shape[1])
    cc[:, slot] = c_new[:, 0]
    kr[:, slot] = k_rope_new[:, 0]

    wukv = p["wukv"].reshape(m.kv_lora_rank, H, nope + vd)
    wuk, wuv = wukv[..., :nope], wukv[..., nope:]
    q_eff = torch.einsum("bqhn,khn->bqhk", q_nope, wuk)     # [B,1,H,kvlora]
    s = (torch.einsum("bqhk,bsk->bhs", q_eff.float(), cc.float())
         + torch.einsum("bqhr,bsr->bhs", q_rope.float(), kr.float())) \
        * (nope + rd) ** -0.5
    posi = torch.arange(cc.shape[1], device=h.device)
    s = torch.where((posi <= pos)[None, None, :], s, ll.NEG_INF)
    pweights = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", pweights, cc.float())
    o = torch.einsum("bhk,khv->bhv", ctx, wuv.float())
    return o.reshape(B, 1, H * vd).to(h.dtype) @ p["wo"]


def _block_decode(cfg, p, cache_l, x, pos, window):
    """One block of one step; ``cache_l`` is this layer's view of the
    step's own cache copy, written in place."""
    h = ll.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = s = None
    if "attn" in p:
        a = _attn_decode(cfg, p["attn"], h, cache_l["attn"], pos, window)
    if "ssm" in p:
        c = cache_l["ssm"]
        s, conv, st = ssm_mod.ssm_decode_step(cfg, p["ssm"], h, c["conv"],
                                              c["state"])
        c["conv"].copy_(conv)
        c["state"].copy_(st)
    x = x + _mixers(a, s)
    if "xattn" in p:
        hx = ll.rmsnorm(x, p["lnx"], cfg.norm_eps)
        B = x.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        q = (hx @ p["xattn"]["wq"]).reshape(B, 1, H, hd)
        o = ll.decode_attention(q, cache_l["xk"], cache_l["xv"],
                                cache_l["xk"].shape[1], window=0)
        x = x + o.reshape(B, 1, -1) @ p["xattn"]["wo"]
    if "moe" in p:
        h2 = ll.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + ll.moe_block(cfg, p["moe"], h2, _capacity(cfg, x.shape[0]))
    elif "mlp" in p:
        h2 = ll.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + ll.mlp(cfg, p["mlp"], h2)
    return x


def _step_copy(group):
    """The step's own copy of a cache group: every slab a step writes is
    cloned once; the read-only cross-attention slabs are shared."""
    return {k: (v if k in _READ_ONLY else
                _step_copy(v) if isinstance(v, dict) else v.clone())
            for k, v in group.items()}


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One serving step: tokens [B,1] -> (logits [B,1,V], new cache).  The
    input cache is left as it was."""
    pos = cache["step"]
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = _scale_embed(cfg, x)

    new_cache = {"step": pos + 1}
    if "dense" in cache:
        db = params["dense_blocks"]
        off = db["ln1"].shape[0]
        new_cache["dense"] = dense = _step_copy(cache["dense"])
        for l in range(off):
            x = _block_decode(cfg, _layer(db, l), _layer(dense, l), x, pos,
                              _windows(cfg, 1, l)[0])
    else:
        off = cfg.n_dense_layers if cfg.moe else 0

    blocks = params["blocks"]
    Lm = blocks["ln1"].shape[0]
    new_cache["main"] = main = _step_copy(cache["main"])
    for l, w in enumerate(_windows(cfg, Lm, off)):
        x = _block_decode(cfg, _layer(blocks, l), _layer(main, l), x, pos, w)

    x = ll.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, x), new_cache


# ---------------------------------------------------------------------------
# nn.Module face
# ---------------------------------------------------------------------------

def _register(module: nn.Module, tree) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = nn.Module()
            _register(sub, v)
            module.add_module(k, sub)
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree_of(module: nn.Module) -> dict:
    out = dict(module.named_parameters(recurse=False))
    for k, sub in module.named_children():
        out[k] = _tree_of(sub)
    return out


class TransformerLM(nn.Module):
    """The parameter tree as a module: ``state_dict()`` keys are the
    reference's pytree paths (``blocks.attn.wq``, ...).  ``params`` is the
    nested dict the functions above take (``prefill``, ``init_cache``,
    ``decode_step``, ``LMServer``); calling the module is ``forward``."""

    def __init__(self, cfg: ModelConfig, params=None, *, key=0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        tree = (init_params(cfg, key, dtype, dev) if params is None
                else to_device(params, dev))
        _register(self, tree)

    @property
    def params(self) -> dict:
        return _tree_of(self)

    def forward(self, tokens, enc_frames=None, positions=None, embeds=None):
        return forward(self.cfg, self.params, tokens, enc_frames=enc_frames,
                       positions=positions, embeds=embeds)
