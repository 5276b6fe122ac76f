"""Deterministic, resumable, shardable token pipeline (the port of
``repro.data.pipeline``).

Stateless generation: batch ``step`` of host shard ``h`` is a pure function
of (seed, step, h) through numpy's ``default_rng``, so

* a restart at step k reproduces the exact stream (checkpoint/restart
  safety),
* host shards are disjoint by construction (no coordination),
* no filesystem dependency for benchmarks; a memory-mapped corpus reader
  serves real data.

:func:`global_batch_arrays` places a host batch on a mesh as a DTensor
sharded over the batch axes.

The reference draws from ``jax.random``, which the port does not
reproduce; the recipe is the same (a base token per row, a ramp, noise in
[0, 17), taken mod vocab), the stream is numpy's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def host_batch_size(cfg: DataConfig) -> int:
    if cfg.global_batch % cfg.n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"over {cfg.n_hosts} hosts")
    return cfg.global_batch // cfg.n_hosts


def synthetic_batch(cfg: DataConfig, step: int) -> np.ndarray:
    """[host_batch, seq_len] int32 tokens for this (step, host)."""
    hb = host_batch_size(cfg)
    rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
    # markovian-ish stream: a ramp plus noise, so the loss can fall
    base = rng.integers(0, cfg.vocab, (hb, 1))
    drift = np.arange(cfg.seq_len)[None, :]
    noise = rng.integers(0, 17, (hb, cfg.seq_len))
    return ((base + drift + noise) % cfg.vocab).astype(np.int32)


class CorpusReader:
    """Memory-mapped flat int32 token corpus with deterministic sharded
    windows."""

    def __init__(self, path: str, cfg: DataConfig):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        hb = host_batch_size(cfg)
        n_windows = len(self.tokens) // cfg.seq_len
        rng = np.random.default_rng(cfg.seed + step)
        idx = rng.permutation(n_windows)[
            cfg.host_id * hb:(cfg.host_id + 1) * hb]
        out = np.stack([self.tokens[i * cfg.seq_len:(i + 1) * cfg.seq_len]
                        for i in idx])
        return out.astype(np.int32) % cfg.vocab


def local_slices(gshape, mesh, placements) -> tuple:
    """This rank's slice of each dim of a ``gshape`` tensor laid out by
    ``placements`` on ``mesh`` (even shards; several mesh dims sharding one
    tensor dim split it in mesh-dim order)."""
    from torch.distributed.tensor import Shard

    lo = [0] * len(gshape)
    size = list(gshape)
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(md)
            if size[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(gshape)} does not "
                                 f"split over mesh dim {md} ({n})")
            size[pl.dim] //= n
            lo[pl.dim] += mesh.get_local_rank(md) * size[pl.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def global_batch_arrays(cfg: DataConfig, step: int, mesh, spec):
    """Host batch -> a DTensor of the global batch [global_batch, seq_len]
    laid out by ``spec`` (``sharding.batch_spec``) on ``mesh``.

    Each rank builds only its own shard, from this host's rows: global row
    ``r`` is host row ``r % host_batch``, the reference's
    ``make_array_from_callback`` map (on one host, the host batch itself).
    The shard lives on the mesh's device type.
    """
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    local = synthetic_batch(cfg, step)
    gshape = (cfg.global_batch, cfg.seq_len)
    pl = placements(spec, mesh)
    rows, cols = local_slices(gshape, mesh, pl)
    sel = np.arange(rows.start, rows.stop) % local.shape[0]
    shard = torch.from_numpy(np.ascontiguousarray(local[sel][:, cols]))
    return DTensor.from_local(shard.to(mesh.device_type), mesh, pl,
                              run_check=False, shape=gshape,
                              stride=(gshape[1], 1))
