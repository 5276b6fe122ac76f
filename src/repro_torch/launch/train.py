"""Training launcher: init -> train step -> guarded loop, on one device (the
port of ``repro.launch.train``).

``--mesh host`` trains on one device: the card by default, the CPU with
``--device cpu``.  The reference's pod meshes come with the distributed
slice.  Fault tolerance: periodic checkpoints + ``StepGuard`` restore and
replay; ``--fault-inject N`` kills step N once to exercise the path.

Usage (CPU example, also examples/train_lm_torch.py):
    python -m repro_torch.launch.train --device cpu --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.packed import resolve_device
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.distributed.fault import SimulatedFault, StepGuard
from repro_torch.models import transformer as T
from repro_torch.obs.timing import Stopwatch
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_psum_tree, init_residuals
from repro_torch.tree import flatten, unflatten


def loss_and_grads(cfg, params, tokens, enc_frames=None):
    """(loss, gradient tree) of ``loss_fn`` on ``tokens`` [B, S] (and the
    enc-dec family's encoder frames); ``params`` is left as it was."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten(params).items()}
    loss = T.loss_fn(cfg, unflatten(leaves), tokens, enc_frames=enc_frames)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), unflatten(dict(zip(leaves, grads)))


def build_train_step(cfg, ocfg, *, grad_compress: bool = False, group=None):
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).

    With ``grad_compress`` the gradients go through the int8
    error-feedback all-reduce over ``group`` (the identity on one rank),
    its residuals carried in ``opt_state["residuals"]``."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        residuals = None
        if grad_compress:
            residuals = opt_state.get("residuals")
            if residuals is None:
                residuals = init_residuals(grads)
            grads, residuals = compress_psum_tree(grads, residuals, group)
        params, opt_state, m = adamw.apply_updates(params, grads, opt_state,
                                                   ocfg)
        if residuals is not None:
            opt_state["residuals"] = residuals
        m["loss"] = loss
        return params, opt_state, m

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fault-inject", type=int, default=-1)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the production meshes come with the "
            "distributed slice (ROADMAP queue 1, item 10c); the port trains "
            "on one device (--mesh host)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    print(f"mesh: {{'data': 1, 'model': 1}} on {dev}")

    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)

    params = T.init_params(cfg, 0, dtype=dtype, device=dev)
    opt_state = adamw.init_state(params, ocfg)
    if args.grad_compress:
        opt_state["residuals"] = init_residuals(params)
    step_fn = build_train_step(cfg, ocfg, grad_compress=args.grad_compress)

    start = 0
    if args.resume:
        last = store.latest_step(args.ckpt_dir)
        if last is not None:
            state = store.restore(args.ckpt_dir, last,
                                  {"p": params, "o": opt_state}, device=dev)
            params, opt_state = state["p"], state["o"]
            start = last
            print(f"resumed from step {start}")

    guard = StepGuard(args.ckpt_dir, args.ckpt_every)
    faults_left = {"n": 1 if args.fault_inject >= 0 else 0}

    def one_step(carry, step):
        params, opt_state = carry
        if faults_left["n"] and step == args.fault_inject:
            faults_left["n"] -= 1
            raise SimulatedFault(f"injected at step {step}")
        batch = torch.from_numpy(synthetic_batch(dcfg, step)).to(dev)
        params, opt_state, m = step_fn(params, opt_state, batch)
        return (params, opt_state), m

    def restore_fn():
        last = store.latest_step(args.ckpt_dir)
        if last is None:
            return (params, opt_state)
        st = store.restore(args.ckpt_dir, last,
                           {"p": params, "o": opt_state}, device=dev)
        print(f"  [guard] restored step {last}")
        return (st["p"], st["o"])

    carry = (params, opt_state)
    sw = Stopwatch()
    for step in range(start, args.steps):
        sw.lap()
        carry, m = guard.run(one_step, carry, step, restore_fn)
        if step % args.ckpt_every == 0 or step == args.steps - 1:
            store.save(args.ckpt_dir, step, {"p": carry[0], "o": carry[1]})
        print(f"step {step:4d} loss={float(m['loss']):.4f} "
              f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
              f"{sw.lap():.2f}s")
    return float(m["loss"])


if __name__ == "__main__":
    main()
