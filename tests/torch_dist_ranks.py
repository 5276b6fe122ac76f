"""Multi-rank helpers of the port's distributed tests: ``spawn`` and the
rank functions a spawn runs.  A jax-free module, so the 8 spawned ranks
import neither JAX nor the reference: they start faster and share the
cores with the other test workers less."""

import contextlib
import io
import os
import time

import numpy as np
import torch

from repro_torch.distributed import sharding as SH

WORLD = 8


def spawn(fn, args, timeout: float):
    """Run ``fn(rank, *args)`` on WORLD processes; fail on an error or on
    the timeout (a deadlocked collective), leaving no process behind."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=args, nprocs=WORLD, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{WORLD} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


def substrate_rank_main(rank: int, init: str, work: str) -> None:
    """One rank of ``tests/test_torch_distributed.py``'s spawn: its
    results go to ``work/rank<r>.npz``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=WORLD)
    try:
        res = _substrate_checks(rank, work)
        np.savez(os.path.join(work, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _substrate_checks(rank: int, work: str) -> dict:
    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.optim.compression import quantize_psum

    res = {}
    # a checkpoint saved on (4, 2) restored onto (2, 4) and (8, 1)
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
        np.float32)), "b": torch.arange(8, dtype=torch.int32),
        "h": torch.from_numpy(rng.standard_normal((8, 16)).astype(
            np.float32)).to(torch.bfloat16)}
    a = make_mesh((4, 2), ("data", "model"), device="cpu")
    spec = {"w": ("data", "model"), "b": ("model",), "h": (None, "data")}
    sh_a = {k: SH.placements(v, a) for k, v in spec.items()}
    ckpt = os.path.join(work, "ckpt")
    store.save(ckpt, 3, SH.distribute(tree, a, sh_a))
    for shape in ((2, 4), (8, 1)):
        b = make_mesh(shape, ("data", "model"), device="cpu")
        sh_b = {k: SH.placements(v, b) for k, v in spec.items()}
        out = store.restore(ckpt, 3, tree, mesh=b, shardings=sh_b)
        for k, v in out.items():
            assert tuple(v.placements) == sh_b[k], (k, v.placements)
            res[f"restore/{shape}/{k}"] = v.full_tensor().view(
                torch.int16 if v.dtype == torch.bfloat16 else v.dtype
            ).numpy()
        rep = store.restore(ckpt, 3, tree, mesh=b)
        res[f"replicated/{shape}"] = np.array(
            all(all(p.is_replicate() for p in v.placements)
                for v in rep.values()))

    # int8 error feedback over the 8-rank group, each rank its own gradient
    g = torch.from_numpy(np.random.default_rng(100 + rank).standard_normal(
        (64, 33)).astype(np.float32))
    r = torch.from_numpy(np.random.default_rng(200 + rank).standard_normal(
        (64, 33)).astype(np.float32) * 1e-3)
    mean, new_r = quantize_psum(g, r, dist.group.WORLD)
    res["psum/mean"], res["psum/res"] = mean.numpy(), new_r.numpy()

    # the launcher, as torchrun starts it
    from repro_torch.launch import train

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD))
    losses = []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--device", "cpu", "--mesh", "host", "--reduced",
                    "--steps", "6", "--batch", "8", "--seq", "32",
                    "--ckpt-every", "2", "--fault-inject", "3",
                    "--grad-compress", "--lr", "3e-3",
                    "--ckpt-dir", os.path.join(work, "train")])
    for line in buf.getvalue().splitlines():
        if line.startswith("step"):
            losses.append(float(line.split("loss=")[1].split()[0]))
    res["train/losses"] = np.array(losses)
    res["train/restored"] = np.array("[guard] restored" in buf.getvalue())
    return res
