"""Monotonic duration timing, shared by launch/serving/bench code.

``time.time()`` is wall-clock: NTP slews and DST jumps make it lie about
durations.  Everything in this repo that measures *how long something
took* goes through ``monotonic()`` / ``Stopwatch`` so the choice is made
once, here.
"""

from __future__ import annotations

import time
from typing import Optional


def monotonic() -> float:
    """The repo-wide duration clock (``time.perf_counter``)."""
    return time.perf_counter()


class Stopwatch:
    """Monotonic stopwatch: ``lap()`` returns-and-restarts, or use as a
    context manager and read ``.seconds`` after exit."""

    __slots__ = ("t0", "seconds")

    def __init__(self):
        self.t0 = monotonic()
        self.seconds: Optional[float] = None

    def lap(self) -> float:
        now = monotonic()
        dt, self.t0 = now - self.t0, now
        return dt

    def elapsed(self) -> float:
        return monotonic() - self.t0

    def __enter__(self) -> "Stopwatch":
        self.t0 = monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = monotonic() - self.t0
