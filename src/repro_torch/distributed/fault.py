"""Fault tolerance: step guard, straggler policy, elastic re-mesh planning
(a copy of ``repro.distributed.fault``).

A deployment surfaces device or host failures as exceptions out of the
step function (and slow hosts as barrier timeouts).  This module packages
the control-plane reaction:

* ``StepGuard`` wraps the train step; on failure it restores the latest
  complete checkpoint and replays (the data pipeline is stateless in step,
  so replay is exact).  Retries are bounded; repeated failure at the same
  step triggers an elastic resize request.
* ``plan_remesh``: given the healthy-device count, the largest (data,
  model) mesh that keeps the model axis (tensor-parallel degree is a
  property of the program; data parallelism shrinks freely).
* ``StragglerPolicy``: deterministic per-host data shards mean a straggler
  only delays its own shard; the policy records per-step durations and
  flags hosts slower than ``threshold`` x median over a window, feeding
  the resize decision (drop and redistribute).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str          # "device" | "timeout" | "nan"
    detail: str = ""


class SimulatedFault(RuntimeError):
    """Raised by tests and chaos hooks to emulate a device loss."""


def plan_remesh(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid with the same tensor-parallel degree."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_devices} devices")
    return (n_devices // model_parallel, model_parallel)


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 20
    threshold: float = 2.0
    _durations: dict = dataclasses.field(default_factory=dict)

    def record(self, host: int, seconds: float):
        self._durations.setdefault(host, []).append(seconds)
        if len(self._durations[host]) > self.window:
            self._durations[host].pop(0)

    def stragglers(self) -> list[int]:
        if not self._durations:
            return []
        med = sorted(sum(self._durations.values(), []))
        med = med[len(med) // 2]
        return [h for h, ds in self._durations.items()
                if len(ds) >= 3 and sorted(ds)[len(ds) // 2] >
                self.threshold * med]


class StepGuard:
    """Checkpoint-restart wrapper around a step callable."""

    def __init__(self, ckpt_dir: str, save_every: int, *,
                 max_retries: int = 2, on_resize=None):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_retries = max_retries
        self.on_resize = on_resize
        self.events: list[FailureEvent] = []

    def run(self, step_fn, state, step: int, restore_fn):
        """Execute step_fn(state, step); on failure restore + replay."""
        for attempt in range(self.max_retries + 1):
            try:
                return step_fn(state, step)
            except SimulatedFault as e:      # device loss
                self.events.append(FailureEvent(step, "device", str(e)))
                if attempt == self.max_retries:
                    if self.on_resize is not None:
                        state = self.on_resize(state)
                        return step_fn(state, step)
                    raise
                state = restore_fn()
        raise AssertionError("unreachable")
