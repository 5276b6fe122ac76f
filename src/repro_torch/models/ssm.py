"""Mamba-2 SSD block (state-space duality) — chunked scan and step decode.

Mirrors ``repro.models.ssm``.  The SSD forward is the blocked algorithm of
Dao & Gu (2024): the sequence is split into chunks; *intra-chunk* terms are
a masked attention-like product, *inter-chunk* terms ride a [B,H,N,P]
state carried from chunk to chunk (a Python loop where the reference scans).
The per-token recurrence is

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D * x_t

``ssd_sequential`` is the O(S) oracle the chunked form is tested against;
``ssm_decode_step`` is the O(1)-per-token serving path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.hints import local_batch
from repro_torch.distributed.hints import pad as _pad

from .layers import ParamInit, rmsnorm


def init_ssm(cfg, init: ParamInit, L, dtype):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.n_heads * s.head_dim
    conv_ch = d_in + 2 * s.state_dim          # x, B, C share the causal conv
    return dict(
        in_proj=init.dense((L, d, 2 * d_in + 2 * s.state_dim + s.n_heads),
                           dtype),
        conv_w=init.dense((L, s.conv_width, conv_ch), dtype,
                          scale=s.conv_width ** -0.5),
        conv_b=init.zeros((L, conv_ch), dtype),
        A_log=init.zeros((L, s.n_heads), torch.float32),
        dt_bias=init.zeros((L, s.n_heads), torch.float32),
        D=init.ones((L, s.n_heads), torch.float32),
        norm=init.zeros((L, d_in), dtype),
        out_proj=init.dense((L, d_in, d), dtype),
    )


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_in = s.n_heads * s.head_dim
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * s.state_dim]
    dt = proj[..., -s.n_heads:]
    return z, xBC, dt


def _causal_conv(xBC, w, b, state=None):
    """Depthwise causal conv1d, width W.  xBC [B,S,C]; w [W,C]; b [C].

    An explicit sum over the width, as the reference writes it (no conv1d,
    whose library path may pick reduced-precision algorithms).
    state (decode): [B, W-1, C] previous inputs; returns (out, new_state).
    """
    W = w.shape[0]
    if state is None:
        pad = _pad(xBC, (0, 0, W - 1, 0))
    else:
        pad = torch.cat([state.to(xBC.dtype), xBC], dim=1)
    S = xBC.shape[1]
    out = sum(pad[:, i:i + S] * w[i] for i in range(W)) + b
    new_state = pad[:, -(W - 1):] if W > 1 else None
    return F.silu(out), new_state


def softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _gates(cfg, p_dt_bias, p_A_log, dt_raw):
    dt = softplus(dt_raw.float() + p_dt_bias)                      # [B,S,H]
    A = -torch.exp(p_A_log)                                        # [H]
    return dt, A * dt                                              # dt, logdecay


def ssd_chunked(cfg, x, Bm, Cm, dt, log_dA, init_state=None):
    """Blocked SSD scan.

    x [B,S,H,P]; Bm/Cm [B,S,N]; dt/log_dA [B,S,H].
    Returns (y [B,S,H,P], final_state [B,H,N,P] f32).
    """
    s = cfg.ssm
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(s.chunk, S)
    pad = (-S) % Q
    if pad:
        # identity pads: dt=0 and log_dA=0 contribute nothing to y or state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        log_dA = F.pad(log_dA, (0, 0, 0, pad))
    nc = (S + pad) // Q
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))

    state = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq = x[:, sl].float()
        Bq, Cq = Bm[:, sl].float(), Cm[:, sl].float()
        dtq, ldq = dt[:, sl], log_dA[:, sl]
        cum = torch.cumsum(ldq, dim=1)                     # [B,Q,H] inclusive
        # intra: scores[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i
        scores = torch.einsum("bqn,bkn->bqk", Cq, Bq)
        decay = cum[:, :, None, :] - cum[:, None, :, :]    # [B,Q,Q,H]
        w = torch.where(causal[None, :, :, None],
                        torch.exp(decay) * dtq[:, None, :, :], 0.0)
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, w, xq)
        # inter: contribution of the carried state
        y = y + torch.einsum("bqn,bqh,bhnp->bqhp", Cq, torch.exp(cum), state)
        # state update
        tail = torch.exp(cum[:, -1:, :] - cum) * dtq       # [B,Q,H]
        c_state = torch.einsum("bqh,bqn,bqhp->bhnp", tail, Bq, xq)
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + c_state
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def ssd_sequential(cfg, x, Bm, Cm, dt, log_dA, init_state=None):
    """O(S) per-token reference recurrence (oracle for tests)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        h = h * torch.exp(log_dA[:, t])[..., None, None] + \
            torch.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t].float(),
                         x[:, t].float())
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssm_forward(cfg, p, x, *, chunked=True, init_state=None):
    """Full mamba2 mixer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    x [B,S,d] -> (y [B,S,d], (conv_state, ssd_state)) for decode handoff.
    """
    s = cfg.ssm
    B, S, _ = x.shape
    z, xBC, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    d_in = s.n_heads * s.head_dim
    xs = xBC[..., :d_in].reshape(B, S, s.n_heads, s.head_dim)
    Bm = xBC[..., d_in:d_in + s.state_dim]
    Cm = xBC[..., d_in + s.state_dim:]
    dt, log_dA = _gates(cfg, p["dt_bias"], p["A_log"], dt_raw)
    ssd = ssd_chunked if chunked else ssd_sequential
    y, state = local_batch(ssd, cfg, xs, Bm, Cm, dt, log_dA,
                           init_state=init_state)
    y = y + (p["D"][None, None, :, None] * xs.float()).to(y.dtype)
    y = y.reshape(B, S, d_in) * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], (conv_state, state)


def ssm_decode_step(cfg, p, x, conv_state, ssd_state):
    """One-token step.  x [B,1,d]; states from prefill.  O(1) in seq len."""
    s = cfg.ssm
    B = x.shape[0]
    z, xBC, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xBC, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                   state=conv_state)
    d_in = s.n_heads * s.head_dim
    xs = xBC[..., :d_in].reshape(B, 1, s.n_heads, s.head_dim)[:, 0]
    Bm = xBC[:, 0, d_in:d_in + s.state_dim]
    Cm = xBC[:, 0, d_in + s.state_dim:]
    dt, log_dA = _gates(cfg, p["dt_bias"], p["A_log"], dt_raw[:, 0])

    h = ssd_state * torch.exp(log_dA)[..., None, None] + \
        torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), xs.float())
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(B, 1, d_in).to(x.dtype) * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], conv_state, h
