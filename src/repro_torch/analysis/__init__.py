"""repolint for the port: its invariants as a blocking static pass.

Usage::

    python -m repro_torch.analysis src/repro_torch   # text report, exit 1
    python -m repro_torch.analysis --format json
    python -m repro_torch.analysis --select hot-path-sync
    python -m repro_torch.analysis --list-rules

The port's own copy of the reference's ``repro.analysis`` (stdlib only;
the port imports nothing of the reference).  The framework — loader, call
graph, suppressions, reporters, CLI — is unchanged; the rules speak torch:
serving entries registered with ``core.packed.SERVING_ENTRIES`` and no
``torch.compile`` behind ``TRACES``' back (``entry-registry``), no host
syncs (``.item()``, ``.cpu()``, ``.synchronize()`` ...) on the staged
dispatch path (``hot-path-sync``), subsystem import layering with no
``jax`` or ``repro`` anywhere (``layering``), monotonic timing, and a
deadlock-free lock acquisition order over ``obs.locks.LOCK_RANKS``.
Suppress a single site with ``# repolint: disable=<rule> -- <why>``.
"""

from __future__ import annotations

from . import checkers  # noqa: F401  (registers the built-in rules)
from .base import (Finding, Rule, get_rule, register, render_json,
                   render_text, rules, run, suppressed)
from .callgraph import CallGraph, ClassInfo, FuncInfo
from .loader import ImportEdge, Module, Project, load_file, load_project

__all__ = [
    "Finding", "Rule", "register", "rules", "get_rule", "run",
    "suppressed", "render_text", "render_json",
    "CallGraph", "FuncInfo", "ClassInfo",
    "ImportEdge", "Module", "Project", "load_file", "load_project",
    "main",
]

from .cli import main  # noqa: E402  (CLI reuse in tests)
