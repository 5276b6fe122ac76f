"""Deterministic, resumable, shardable token pipeline (the port of
``repro.data.pipeline``).

Stateless generation: batch ``step`` of host shard ``h`` is a pure function
of (seed, step, h) through numpy's ``default_rng``, so

* a restart at step k reproduces the exact stream (checkpoint/restart
  safety),
* host shards are disjoint by construction (no coordination),
* no filesystem dependency for benchmarks; a memory-mapped corpus reader
  serves real data.

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
