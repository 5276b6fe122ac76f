"""Live workload capture — the ``w_c`` histogram of workload-aware EHL*.

The paper's workload-aware mode (``s(c) = 1 + w_c``, Eq. 5) assumes the
query distribution is known offline.  In the serving stack the distribution
is *discovered*: every answered query's endpoints are folded into a decayed
per-cell histogram, which the
:class:`~repro_torch.indexing.planner.BudgetPlanner` reads back as
compression scores.

Properties:

* **O(1) per endpoint** — a float64 floor-divide cell mapping, vectorised
  over the batch (the reference's arithmetic, so the histogram equals its
  histogram);
* **bounded memory** — one float64 per grid cell (the [C] vector), no
  per-query state, regardless of traffic volume;
* **recency-weighted** — exponential decay with a configurable half-life
  measured in *queries*, so a shifted workload overtakes the old mass after
  ~a few half-lives instead of being averaged against all of history;
* **thread-safe** — the serving loop records while the manager's background
  build reads a consistent copy.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.locks import make_lock


class WorkloadRecorder:
    """Decayed per-cell endpoint histogram over the index grid."""

    def __init__(self, nx: int, ny: int, cell_size: float,
                 halflife: float = 4000.0):
        self.nx = int(nx)
        self.ny = int(ny)
        self.cell_size = float(cell_size)
        self.halflife = float(halflife)
        # decay applied per recorded *query* (two endpoints)
        self._decay = 0.5 ** (1.0 / halflife) if halflife > 0 else 1.0
        self.w = np.zeros(self.nx * self.ny, dtype=np.float64)
        self.queries = 0            # total queries ever recorded
        self._lock = make_lock("workload.recorder")

    @classmethod
    def for_index(cls, index, **kw) -> "WorkloadRecorder":
        """Recorder over an ``EHLIndex``'s (or packed artifact's) grid."""
        return cls(index.nx, index.ny, index.cell_size, **kw)

    # ------------------------------------------------------------------ I/O
    def _cells(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        ix = np.clip((pts[:, 0] / self.cell_size).astype(np.int64),
                     0, self.nx - 1)
        iy = np.clip((pts[:, 1] / self.cell_size).astype(np.int64),
                     0, self.ny - 1)
        return iy * self.nx + ix

    def record(self, s: np.ndarray, t: np.ndarray) -> None:
        """Fold a served batch's endpoints into the histogram."""
        cells = np.concatenate([self._cells(s), self._cells(t)])
        n = cells.size // 2
        if n == 0:
            return
        counts = np.bincount(cells, minlength=self.w.size).astype(np.float64)
        with self._lock:
            self.w *= self._decay ** n      # age existing mass
            self.w += counts
            self.queries += n

    # ------------------------------------------------------------- read-out
    def workload(self) -> np.ndarray:
        """[C] decayed endpoint counts w_c (a consistent copy)."""
        with self._lock:
            return self.w.copy()

    def scores(self) -> np.ndarray:
        """Paper's workload-aware initialisation: s(c) = 1 + w_c."""
        return 1.0 + self.workload()

    def distribution(self) -> np.ndarray:
        """[C] normalized workload (uniform if nothing recorded yet)."""
        w = self.workload()
        tot = w.sum()
        if tot <= 0.0:
            return np.full(w.size, 1.0 / w.size)
        return w / tot

    def reset(self) -> None:
        with self._lock:
            self.w[:] = 0.0
            self.queries = 0
