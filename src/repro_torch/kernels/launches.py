"""Launch accounting of the hand-written kernels, eager and replayed.

Each launch wrapper (``segvis``, ``segvis_tiles``, ``label_join_rowmin``)
reports every launch with :func:`count`: one more on the wrapper's
``launches`` attribute, and the launch's analytic cost to the installed
profile capture (``obs.profile.note_kernel``).  A launch made while the
calling thread captures a CUDA graph (:func:`recording`) runs only when
the graph is replayed, so it is recorded instead of counted, and
:func:`replay` counts the recorded launches once per replay: the counters
then read the same whether a batch ran eagerly or as a graph.
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.obs.profile import note_kernel


class _Recording(threading.local):
    launches = None     # the capturing thread's list, else None


_REC = _Recording()


def count(wrapper, kernel: str, shape: tuple, dist_bytes: int = 4) -> None:
    """One launch of ``kernel`` by ``wrapper`` at ``shape``."""
    rec = _REC.launches
    if rec is not None:
        rec.append((wrapper, kernel, shape, dist_bytes))
        return
    wrapper.launches += 1
    note_kernel(kernel, shape, dist_bytes)


@contextlib.contextmanager
def recording():
    """Record, rather than count, this thread's launches inside the block;
    yields the list of them for :func:`replay`."""
    prev = _REC.launches
    _REC.launches = rec = []
    try:
        yield rec
    finally:
        _REC.launches = prev


def replay(launches) -> None:
    """Count the launches :func:`recording` recorded, as run once more."""
    for wrapper, kernel, shape, dist_bytes in launches:
        wrapper.launches += 1
        note_kernel(kernel, shape, dist_bytes)
