"""Budgeted replanning — when and how to re-optimize the index for traffic.

The planner closes the gap between the paper's one-shot workload-aware
compression and a live system: it compares the recorded workload against the
one the serving artifact was last compressed under and picks the cheapest
sufficient action:

* ``skip``        — distribution stable and the artifact fits the budget;
* ``incremental`` — the artifact overflows a (possibly shrunk) budget but
  the distribution is stable: resume Algorithm 1 from the *current* region
  set (``compress_incremental``), no rebuild;
* ``replan``      — the distribution drifted past threshold: restore the
  base singleton-region snapshot and recompress with fresh Eq. 5 scores.
  Merges are irreversible, so re-splitting regions that earlier merges
  coarsened requires re-entering the loop from the snapshot — still far
  cheaper than ``build_ehl`` (no visibility polygons, no hub labels).

Drift is total-variation distance between normalized workloads; the budget
is a **device-byte** budget on the packed bucketed artifact
(``compress_to_device_budget``), i.e. what serving actually allocates.

**Hysteresis.**  A replan is expensive (host merge loop + repack + probe
validation) and resets the drift baseline, so a workload hovering *at* the
threshold would otherwise re-trigger on every noise excursion — swap churn.
Two guards stop it:

* enter/exit thresholds (a Schmitt trigger): the drift alarm raises at
  ``replan_threshold`` and stays latched until drift falls to
  ``exit_threshold`` — a brief dip back under the enter threshold neither
  clears the alarm nor re-fires it;
* min-dwell: after a *committed* replan, ``min_dwell`` further eligible
  ``decide()`` calls must pass before the next replan, bounding the replan
  rate regardless of how the drift signal oscillates.

Budget-overflow ``incremental`` decisions bypass both guards — holding the
device budget is a correctness property, churn control is not allowed to
defer it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.compression import (CompressionStats,
                                          compress_to_device_budget)
from repro_torch.core.packed import LAYOUT_F32, bucketed_device_bytes


@dataclasses.dataclass
class PlanDecision:
    kind: str           # "skip" | "incremental" | "replan"
    drift: float        # TV distance vs. the last planned-under workload
    reason: str


class BudgetPlanner:
    """Decide + execute recompression against a recorded workload."""

    def __init__(self, device_budget_bytes: int, alpha: float = 0.2,
                 min_queries: int = 256, replan_threshold: float = 0.15,
                 exit_threshold: float | None = None, min_dwell: int = 2,
                 lane: int = 128, layout=None):
        self.device_budget_bytes = int(device_budget_bytes)
        self.layout = layout if layout is not None else LAYOUT_F32
        self.alpha = float(alpha)
        self.min_queries = int(min_queries)
        self.replan_threshold = float(replan_threshold)
        # hysteresis: alarm clears only below exit (default half of enter);
        # min_dwell eligible decide() calls must pass between replans
        self.exit_threshold = (float(exit_threshold)
                               if exit_threshold is not None
                               else self.replan_threshold / 2.0)
        if self.exit_threshold > self.replan_threshold:
            raise ValueError("exit_threshold must be <= replan_threshold")
        self.min_dwell = int(min_dwell)
        self.lane = int(lane)
        self._planned_dist: np.ndarray | None = None
        self._planned_at_queries = 0
        self._pending: tuple | None = None
        self._alarm = False
        self._dwell_left = 0
        # drift-trigger observability (DESIGN.md §12): decision mix,
        # live drift and alarm state as per-planner registry series
        self._obs_labels = {"planner": obs.next_instance_id("p")}
        # structured decision/execution records (DESIGN.md §13): the
        # manager points this at its Telemetry's EventLog; standalone
        # planners leave it None and skip the records
        self.events: obs.EventLog | None = None
        self._last_dev = 0

    # ------------------------------------------------------------ decisions
    def drift(self, recorder) -> float:
        """TV distance between recorder state and the last plan's workload."""
        if self._planned_dist is None:
            return 1.0
        return 0.5 * float(np.abs(recorder.distribution()
                                  - self._planned_dist).sum())

    def decide(self, recorder, index) -> PlanDecision:
        d = self._decide(recorder, index)
        reg = obs.REGISTRY
        reg.counter("planner_decisions_total", kind=d.kind,
                    **self._obs_labels).inc()
        reg.gauge("planner_drift", **self._obs_labels).set(d.drift)
        reg.gauge("planner_alarm", **self._obs_labels).set(int(self._alarm))
        if self.events is not None and d.kind != "skip":
            # skips fire every serving block — only actionable decisions
            # become structured records (budget pressure + alarm state)
            self.events.emit("plan_decision", decision=d.kind, drift=d.drift,
                             reason=d.reason,
                             budget_bytes=self.device_budget_bytes,
                             device_bytes=self._last_dev,
                             alarm=self._alarm,
                             dwell_left=self._dwell_left)
        return d

    def _decide(self, recorder, index) -> PlanDecision:
        dev = bucketed_device_bytes(index, self.lane, layout=self.layout)
        self._last_dev = int(dev)
        fresh = recorder.queries - self._planned_at_queries
        if fresh < self.min_queries:
            if dev > self.device_budget_bytes:
                return PlanDecision("incremental", 0.0,
                                    f"artifact {dev}B over budget "
                                    f"{self.device_budget_bytes}B")
            return PlanDecision("skip", 0.0,
                                f"only {fresh} queries since last plan")
        d = self.drift(recorder)
        # min-dwell: every *eligible* decide() call (enough fresh traffic)
        # burns one dwell credit, alarmed or calm — a long calm stretch
        # after a replan uses the window up, so a genuine later shift is
        # not penalized for churn that never happened
        dwelling = self._dwell_left > 0
        if dwelling:
            self._dwell_left -= 1
        # Schmitt trigger: raise at enter, clear only at exit — the alarm
        # latches across dips into the (exit, enter) band
        if not self._alarm and d >= self.replan_threshold:
            self._alarm = True
        elif self._alarm and d <= self.exit_threshold:
            self._alarm = False
        if self._alarm and dwelling:
            if dev > self.device_budget_bytes:
                return PlanDecision("incremental", d,
                                    f"artifact {dev}B over budget "
                                    f"{self.device_budget_bytes}B")
            return PlanDecision(
                "skip", d, f"drift {d:.3f} alarmed but dwelling "
                f"({self._dwell_left + 1} more decisions before replan)")
        if self._alarm:
            return PlanDecision("replan", d,
                                f"workload drift {d:.3f} >= "
                                f"{self.replan_threshold} (alarm latched)")
        if dev > self.device_budget_bytes:
            return PlanDecision("incremental", d,
                                f"artifact {dev}B over budget "
                                f"{self.device_budget_bytes}B")
        return PlanDecision("skip", d,
                            f"drift {d:.3f} below enter threshold "
                            f"{self.replan_threshold}")

    # ------------------------------------------------------------ execution
    def execute(self, decision: PlanDecision, index, recorder,
                base_snapshot: dict | None = None) -> CompressionStats:
        """Mutate ``index`` per the decision; returns compression stats.

        ``replan`` needs the base snapshot (singleton regions, taken right
        after ``build_ehl``); ``incremental`` resumes in place.

        The plan is *pending* until :meth:`commit` — drift keeps being
        measured against the last **published** plan, so an aborted swap
        (validation failure) doesn't trick the planner into thinking the
        workload was already served.  Call :meth:`discard` on abort.
        """
        scores = recorder.scores()
        if decision.kind == "replan":
            if base_snapshot is None:
                raise ValueError("replan needs the base region snapshot")
            index.restore_regions(base_snapshot)
            stats = compress_to_device_budget(
                index, self.device_budget_bytes, cell_scores=scores,
                alpha=self.alpha, lane=self.lane, layout=self.layout)
        elif decision.kind == "incremental":
            stats = compress_to_device_budget(
                index, self.device_budget_bytes, cell_scores=scores,
                alpha=self.alpha, lane=self.lane, layout=self.layout)
        else:
            raise ValueError(f"nothing to execute for {decision.kind!r}")
        self._pending = (recorder.distribution(), recorder.queries)
        if self.events is not None:
            # the budget-in/out + regions-admitted/evicted record the
            # attribution layer joins against the swap's BUILD_STAGES span
            self.events.emit(
                "plan_execute", decision=decision.kind,
                budget_bytes=self.device_budget_bytes,
                label_bytes_in=stats.initial_bytes,
                label_bytes_out=stats.final_bytes,
                device_bytes=stats.device_bytes,
                regions_in=stats.regions + stats.merges,
                regions_admitted=stats.regions,
                regions_evicted=stats.merges,
                hit_single_region=stats.hit_single_region)
        return stats

    def commit(self) -> None:
        """Adopt the pending plan's workload as the planned-under baseline
        (call after the artifact built from it was published).

        Publishing also clears the drift alarm (drift vs the new baseline
        restarts near zero) and arms the min-dwell window: the next replan
        needs ``min_dwell`` further eligible ``decide()`` calls first.
        """
        if self._pending is not None:
            self._planned_dist, self._planned_at_queries = self._pending
            self._pending = None
            self._alarm = False
            self._dwell_left = self.min_dwell

    def discard(self) -> None:
        """Drop the pending plan (the candidate was rejected)."""
        self._pending = None

    def set_budget(self, device_budget_bytes: int) -> None:
        """Tighten/relax the budget at runtime (next decide() sees it)."""
        self.device_budget_bytes = int(device_budget_bytes)
