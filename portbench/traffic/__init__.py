"""The one traffic generator: requests of (s, t) pairs made from the seed.

A cell's workload file (``portbench/workloads/<cell>.json``) holds the
parameters; nothing here knows a cell by name.

Endpoints are uniform over free space (``"distribution": "uniform"``, the
one distribution so far).

* ``"loop": "closed"`` — one client sends a request, waits for its answer,
  sends the next.  Every request has ``pairs_per_request[0]`` to ``[1]``
  pairs, endpoints uniform over free space.  The pool holds
  ``max_requests_per_s`` times the window's seconds distinct requests
  (drawn up front, as set-up), used in turn.
* ``"loop": "open"`` — requests fall due on a fixed schedule whether or not
  earlier ones were answered.  The window holds ``round(rate_per_s *
  seconds)`` requests.  Every seed gets the same work in another order:
  the pair counts are an equal share of each count in
  ``pairs_per_request``, and the gaps are the quantiles of the exponential
  distribution at ``rate_per_s`` (Poisson arrivals), both permuted by the
  seed, the gaps scaled to fill the window exactly.

``seed`` may be any whole number; streams of one seed are independent:
``rng(seed, 0)`` the window's traffic, ``rng(seed, 1)`` the warm-up's,
``rng(seed, 2)`` the sample the reference checks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.scene import Map, free_points

TRAFFIC, WARMUP, SAMPLE = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


@dataclasses.dataclass
class Requests:
    """``n`` requests: request ``i`` is pairs ``lo[i]:lo[i + 1]`` of
    ``s``/``t``; ``due`` (open loop) its offset in seconds from the start
    of the window."""

    s: np.ndarray
    t: np.ndarray
    lo: np.ndarray
    due: np.ndarray | None = None

    @property
    def n(self) -> int:
        return len(self.lo) - 1

    def pairs(self, i: int) -> tuple:
        a, b = self.lo[i], self.lo[i + 1]
        return self.s[a:b], self.t[a:b]

    def size(self, i: int) -> int:
        return int(self.lo[i + 1] - self.lo[i])


def _sizes(spec: dict, n: int, g: np.random.Generator) -> np.ndarray:
    a, b = spec["pairs_per_request"]
    counts = a + np.arange(n) % (b - a + 1)
    return g.permutation(counts)


def _fill(m: Map, sizes: np.ndarray, g: np.random.Generator, due=None):
    total = int(sizes.sum())
    s = free_points(m, total, g)
    t = free_points(m, total, g)
    lo = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return Requests(s, t, lo, due)


def closed(spec: dict, m: Map, seconds: float, g: np.random.Generator
           ) -> Requests:
    n = max(1, math.ceil(spec["max_requests_per_s"] * seconds))
    return _fill(m, _sizes(spec, n, g), g)


def open_schedule(spec: dict, m: Map, seconds: float, g: np.random.Generator,
                  rate: float | None = None) -> Requests:
    rate = float(spec["rate_per_s"] if rate is None else rate)
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = g.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return _fill(m, _sizes(spec, n, g), g, due)


def make(spec: dict, m: Map, seconds: float, g: np.random.Generator,
         rate: float | None = None) -> Requests:
    """The requests of one window of ``seconds`` under ``spec``."""
    if spec["distribution"] != "uniform":
        raise ValueError(f"unknown query distribution "
                         f"{spec['distribution']!r} (uniform)")
    if spec["loop"] == "closed":
        return closed(spec, m, seconds, g)
    if spec["loop"] == "open":
        return open_schedule(spec, m, seconds, g, rate)
    raise ValueError(f"unknown loop {spec['loop']!r}")
