"""monotonic-time: durations and ordering never use wall-clock time.

``time.time()`` jumps under NTP slew and DST; every span, stopwatch, and
latency histogram in the port is monotonic (``time.perf_counter`` via
``obs.timing``).  ``time.time()`` is allowed only in
``repro_torch/obs/timing.py`` (the one module that owns clock choice) and
at explicitly suppressed sites where wall time *is* the datum
(human-readable event timestamps, run metadata), never a duration operand.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..base import Finding, register
from ..loader import Project

_ALLOWED_MODULES = {"repro_torch.obs.timing"}


@register("monotonic-time",
          "time.time() banned outside repro_torch/obs/timing.py")
def check(project: Project) -> Iterator[Finding]:
    for mod in project.modules:
        if mod.name in _ALLOWED_MODULES:
            continue
        # did this module do `from time import time`?
        bare_time = any(e.module == "time" and "time" in e.names
                        for e in mod.imports)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            hit = (isinstance(f, ast.Attribute) and f.attr == "time"
                   and isinstance(f.value, ast.Name)
                   and f.value.id == "time") or \
                  (bare_time and isinstance(f, ast.Name)
                   and f.id == "time")
            if hit:
                yield Finding("monotonic-time", mod.path, node.lineno,
                              node.col_offset,
                              "time.time() is wall-clock; use "
                              "obs.timing (perf_counter) for anything "
                              "ordered or subtracted")
