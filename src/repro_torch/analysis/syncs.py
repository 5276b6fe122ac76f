"""The dynamic complement of ``hot-path-sync``: the syncs the card reports.

``torch.cuda.set_sync_debug_mode("warn")`` makes every CUDA call that
synchronises the host with a stream (``.item()``, ``.cpu()``, a blocking
copy from pageable memory, ``nonzero``, a stream's ``synchronize``) issue a
warning.  :func:`record_syncs` runs a callable under that mode and turns
each such warning into a :class:`SyncSite`.  The warning itself names the
innermost Python frame, which is often torch's own or a ``core`` helper, so
the site walks the interpreter stack at warning time (inside
``warnings.showwarning``) to the innermost frame in the static rule's scope
(``repro_torch.serving`` / ``.sharding``): the line where the hot path
enters the code that synchronised.  The innermost ``repro_torch`` frame
rides along for the report.  :func:`unmarked` returns the sites whose line
carries no ``hot-path-sync`` marker (on it or on the line before), the
syncs the static pass neither flags nor has been told about.

What the mode does not report — ``torch.cuda.Event.synchronize`` and
``torch.cuda.synchronize`` (torch 2.11 on the H100; a stream's
``synchronize`` it does) — only the static rule holds.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import warnings
from typing import Callable, List, Optional

from .base import Finding, suppressed
from .checkers.hot_path_sync import _in_scope
from .loader import Project, load_project

#: the text of PyTorch's sync debug warning
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class SyncSite:
    """One reported sync: its frame in the rule's scope (``module`` is ''
    when no frame of the stack was in it) and the innermost frame of the
    port (``inner``, ``file:line``; the warning's own location when the
    port was not on the stack)."""

    module: str
    path: str
    line: int
    inner: str

    def render(self) -> str:
        where = f"{_short(self.path)}:{self.line}" if self.module else \
            "outside the hot path's packages"
        return where if self.inner == where else f"{where} (in {self.inner})"


def _short(path: str) -> str:
    """``repro_torch/...`` for a file of the port, else the path."""
    head, sep, tail = path.replace(os.sep, "/").rpartition("/repro_torch/")
    return f"repro_torch/{tail}" if sep else path


def _site(filename: str, lineno: int) -> SyncSite:
    scoped = inner = None
    f = sys._getframe(1)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if inner is None and name != __name__ and (
                name == "repro_torch" or name.startswith("repro_torch.")):
            inner = f
        if _in_scope(name):
            scoped = f
            break
        f = f.f_back
    where = (f"{_short(inner.f_code.co_filename)}:{inner.f_lineno}"
             if inner is not None else f"{_short(filename)}:{lineno}")
    if scoped is None:
        return SyncSite("", "", 0, where)
    return SyncSite(scoped.f_globals["__name__"], scoped.f_code.co_filename,
                    scoped.f_lineno, where)


def record_syncs(fn: Callable, *args, **kw):
    """``(fn(*args, **kw), [SyncSite, ...])``: ``fn`` run with PyTorch's
    sync debug mode at "warn" (where a card is present) and every sync
    warning it raised recorded with its site.  Other warnings pass on."""
    import torch

    sites: List[SyncSite] = []
    on_card = torch.cuda.is_available()
    with warnings.catch_warnings(record=True) as others:
        warnings.simplefilter("always")

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            if SYNC_MESSAGE in str(message):
                sites.append(_site(filename, lineno))
            else:
                others.append(warnings.WarningMessage(
                    message, category, filename, lineno, file, line))

        warnings.showwarning = hook      # restored when the block exits
        if on_card:
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **kw)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(prev)
    for w in others:
        warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
    return out, sites


def port_project() -> Project:
    """The parsed tree of the running ``repro_torch`` package."""
    return load_project([_PKG], root=os.path.dirname(_PKG))


def unmarked(sites: List[SyncSite],
             project: Optional[Project] = None) -> List[SyncSite]:
    """The sites whose line carries no ``hot-path-sync`` marker (on the
    line or the one before), and the sites outside the rule's scope."""
    project = project if project is not None else port_project()
    out = []
    for site in sites:
        mod = project.module(site.module) if site.module else None
        if mod is None or not suppressed(mod, Finding(
                "hot-path-sync", mod.path, site.line, 0, "")):
            out.append(site)
    return out
