"""Training launcher: init -> train step -> guarded loop (the port of
``repro.launch.train``).

Run as a plain process, ``--mesh host`` trains on one device: the card by
default, the CPU with ``--device cpu``.  Under ``torchrun`` (whose env,
never a flag here, decides the world), or with ``--mesh pod|multipod``,
the step runs on a ``DeviceMesh``: parameters are initialised, placed by
``sharding.param_shardings`` as DTensors, the batch comes from
``data.pipeline.global_batch_arrays``, and DTensor's propagation inserts
the FSDP/TP collectives.  ``--mesh host`` spans the ranks there are
(``launch.mesh.make_host_mesh``); ``pod`` and ``multipod`` need 256 and
512 ranks.  ``--grad-compress`` runs the int8 error-feedback all-reduce
over the data axes, its residuals local to each rank.  Fault tolerance:
periodic checkpoints + ``StepGuard`` restore and replay; ``--fault-inject
N`` kills step N once to exercise the path.

Usage (CPU example, also examples/train_lm_torch.py):
    python -m repro_torch.launch.train --device cpu --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --mesh host --reduced --steps 8 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.packed import resolve_device
from repro_torch.data.pipeline import (DataConfig, global_batch_arrays,
                                       synthetic_batch)
from repro_torch.distributed import hints
from repro_torch.distributed.fault import SimulatedFault, StepGuard
from repro_torch.models import transformer as T
from repro_torch.obs.timing import Stopwatch
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_psum_tree, init_residuals
from repro_torch.tree import flatten, tree_map, unflatten


def loss_and_grads(cfg, params, tokens, enc_frames=None):
    """(loss, gradient tree) of ``loss_fn`` on ``tokens`` [B, S] (and the
    enc-dec family's encoder frames); ``params`` is left as it was.  A
    leaf the loss never reads (``ln2`` of a block with no MLP, as in
    mamba2's published config) gets a zero gradient, as ``jax.grad``
    gives it."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten(params).items()}
    loss = T.loss_fn(cfg, unflatten(leaves), tokens, enc_frames=enc_frames)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), unflatten({
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), grads)})


def on_mesh(mesh):
    """The context a step runs in on ``mesh``: the mesh registered for the
    model's hints, and plain tensors made inside the step (positions,
    masks, schedule scalars) taken as replicated; nothing without one."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(hints.mesh_hints(mesh))
    stack.enter_context(implicit_replication())
    return stack


def data_group(mesh):
    """The process group over the mesh's data axes (pod and data joined)."""
    from repro_torch.launch.mesh import data_axes

    da = data_axes(mesh)
    if len(da) == 1:
        return mesh.get_group(da[0])
    return mesh[da]._flatten().get_group()


def _compress_on_mesh(grads, residuals, group):
    """The reference's compressed step on a mesh: each rank quantizes the
    full (already reduced) gradient against its own residual, the int8
    payloads are summed over ``group``, and the mean goes back into the
    gradient's layout (a local slice: no traffic)."""
    from torch.distributed.tensor import DTensor, Replicate

    fg = flatten(grads)
    full = {k: g.full_tensor() if isinstance(g, DTensor) else g
            for k, g in fg.items()}
    mean, residuals = compress_psum_tree(unflatten(full), residuals, group)
    fm = flatten(mean)

    def back(k, g):
        if not isinstance(g, DTensor):
            return fm[k]
        rep = DTensor.from_local(fm[k].to(g.dtype), g.device_mesh,
                                 [Replicate()] * g.device_mesh.ndim,
                                 run_check=False)
        return rep.redistribute(g.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in g.placements])

    return unflatten({k: back(k, g) for k, g in fg.items()}), residuals


def build_train_step(cfg, ocfg, *, grad_compress: bool = False, group=None,
                     mesh=None):
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).

    With ``mesh`` the params and batch are DTensors on it and the step runs
    :func:`on_mesh`.  With ``grad_compress`` the gradients go through the
    int8 error-feedback all-reduce over ``group`` (the identity on one
    rank; on a mesh, its data axes), its residuals carried in
    ``opt_state["residuals"]`` as plain tensors local to each rank."""
    if mesh is not None and group is None and grad_compress:
        group = data_group(mesh)

    def step(params, opt_state, batch):
        with on_mesh(mesh):
            loss, grads = loss_and_grads(cfg, params, batch)
            residuals = None
            if grad_compress:
                residuals = opt_state.get("residuals")
                if residuals is None:
                    residuals = init_residuals(grads)
                if mesh is None:
                    grads, residuals = compress_psum_tree(grads, residuals,
                                                          group)
                else:
                    grads, residuals = _compress_on_mesh(grads, residuals,
                                                         group)
            params, opt_state, m = adamw.apply_updates(params, grads,
                                                       opt_state, ocfg)
        if residuals is not None:
            opt_state["residuals"] = residuals
        m["loss"] = loss
        return params, opt_state, m

    return step


def host_float(x) -> float:
    """A 0-dim tensor or DTensor as a Python float (a DTensor's full value
    first: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _launched() -> bool:
    """True under ``torchrun`` (or any launcher that sets the env)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


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

    dev = resolve_device(args.device)
    if _launched() and not torch.distributed.is_initialized():
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        torch.distributed.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo")
    mesh = None
    if args.mesh != "host" or _launched():
        from repro_torch.launch.mesh import (make_host_mesh,
                                             make_production_mesh)
        mesh = (make_host_mesh(device=dev) if args.mesh == "host" else
                make_production_mesh(multi_pod=args.mesh == "multipod",
                                     device=dev))
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    shape = (dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None
             else {"data": 1, "model": 1})
    if rank0:
        print(f"mesh: {shape} on {dev}")

    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5,
                             total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)

    params = T.init_params(cfg, 0, dtype=dtype, device=dev)
    pshard = None
    if mesh is not None:
        from repro_torch.distributed.sharding import (batch_spec, distribute,
                                                      param_shardings)
        pshard = param_shardings(params, mesh)
        params = distribute(params, mesh, pshard)
        bspec = batch_spec(mesh)
    opt_state = adamw.init_state(params, ocfg)
    if args.grad_compress:
        opt_state["residuals"] = init_residuals(params)
    step_fn = build_train_step(cfg, ocfg, grad_compress=args.grad_compress,
                               mesh=mesh)

    def restore(last):
        like = {"p": params, "o": opt_state}
        if mesh is None:
            return store.restore(args.ckpt_dir, last, like, device=dev)
        st = store.restore(args.ckpt_dir, last, like, mesh=mesh,
                           shardings=_shardings_like(like, pshard, mesh))
        if "residuals" in st["o"]:
            # residuals are local to each rank: plain tensors again (the
            # file holds rank 0's)
            st["o"]["residuals"] = tree_map(lambda r: r.to_local(),
                                            st["o"]["residuals"])
        return st

    start = 0
    if args.resume:
        last = store.latest_step(args.ckpt_dir)
        if last is not None:
            state = restore(last)
            params, opt_state = state["p"], state["o"]
            start = last
            if rank0:
                print(f"resumed from step {start}")

    guard = StepGuard(args.ckpt_dir, args.ckpt_every)
    faults_left = {"n": 1 if args.fault_inject >= 0 else 0}

    def one_step(carry, step):
        params, opt_state = carry
        if faults_left["n"] and step == args.fault_inject:
            faults_left["n"] -= 1
            raise SimulatedFault(f"injected at step {step}")
        if mesh is None:
            batch = torch.from_numpy(synthetic_batch(dcfg, step)).to(dev)
        else:
            batch = global_batch_arrays(dcfg, step, mesh, bspec)
        params, opt_state, m = step_fn(params, opt_state, batch)
        return (params, opt_state), m

    def restore_fn():
        last = store.latest_step(args.ckpt_dir)
        if last is None:
            return (params, opt_state)
        st = restore(last)
        if rank0:
            print(f"  [guard] restored step {last}")
        return (st["p"], st["o"])

    carry = (params, opt_state)
    sw = Stopwatch()
    for step in range(start, args.steps):
        sw.lap()
        carry, m = guard.run(one_step, carry, step, restore_fn)
        if step % args.ckpt_every == 0 or step == args.steps - 1:
            store.save(args.ckpt_dir, step, {"p": carry[0], "o": carry[1]})
        loss, gnorm = host_float(m["loss"]), host_float(m["grad_norm"])
        if rank0:
            print(f"step {step:4d} loss={loss:.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={gnorm:.2f} "
                  f"{sw.lap():.2f}s")
    return loss


def _shardings_like(like, pshard, mesh):
    """Placements for every leaf of a {"p", "o"} state: the params' and
    the AdamW moments' from ``pshard``, replicated elsewhere (the step,
    the residuals)."""
    from torch.distributed.tensor import Replicate

    fs = flatten({"p": pshard, "o": {"m": pshard, "v": pshard}})
    return unflatten({k: fs.get(k, [Replicate()] * mesh.ndim)
                      for k in flatten(like)})


if __name__ == "__main__":
    main()
