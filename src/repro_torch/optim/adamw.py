"""AdamW in plain PyTorch: bf16-moment option, global-norm clip, cosine
schedule (the port of ``repro.optim.adamw``).

State is ``{"step", "m", "v"}``, ``m`` and ``v`` nested like the params.
Updates are functional: :func:`apply_updates` returns new tensors and
leaves its inputs as they were.  Every scalar is a 0-dim float32 tensor on
the params' device, as the reference's int32 ``step`` makes its schedule
and bias corrections float32 (Python floats would compute them in float64
and drift by ulps).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: torch.dtype = torch.float32   # bfloat16 halves the state


def init_state(params, cfg: AdamWConfig):
    def zeros(p):
        # zeros_like: a DTensor parameter gets moments with its layout
        return torch.zeros_like(p, dtype=cfg.moment_dtype)

    dev = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_frac``: a float32
    0-dim tensor (``step`` an int or an integer tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` to a global L2 norm of at most ``max_norm``; returns
    (clipped grads, the norm before clipping).  The squares are summed
    leaf by leaf in the reference's (sorted key) order."""
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        gf = g.float()
        mn = b1 * m.float() + (1 - b1) * gf
        vn = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mn / bc1
        vhat = vn / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay \
            * p.float()
        pn = p.float() - lr * delta
        return (pn.to(p.dtype), mn.to(cfg.moment_dtype),
                vn.to(cfg.moment_dtype))

    fp, fg = flatten(params), flatten(grads)
    fm, fv = flatten(state["m"]), flatten(state["v"])
    out = {k: upd(p, fg[k], fm[k], fv[k]) for k, p in fp.items()}
    new_state = {"step": step,
                 "m": unflatten({k: o[1] for k, o in out.items()}),
                 "v": unflatten({k: o[2] for k, o in out.items()})}
    return (unflatten({k: o[0] for k, o in out.items()}), new_state,
            {"lr": lr, "grad_norm": gnorm})
