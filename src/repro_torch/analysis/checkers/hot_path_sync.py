"""hot-path-sync: no host synchronization on the staged dispatch path.

The continuous-batching loop overlaps H2D transfer with device compute by
splitting every query into ``stage()`` (pinned slots, async copies on a
copy stream) and ``dispatch_staged()`` (launch kernels, return a
``Pending``).  Any host sync inside that path serialises the pipeline
without failing a single test: latency just quietly doubles.  Flagged:

* ``.item()``, ``.cpu()``, ``.tolist()`` and ``.to("cpu")`` /
  ``.to(device="cpu")`` / ``.to(torch.device("cpu"))`` — device-to-host
  copies that wait for the stream;
* ``torch.cuda.synchronize()`` and ``.synchronize()`` on anything (events,
  streams);
* ``.nonzero()`` and ``torch.nonzero`` — the output size is data
  dependent, so the host waits for it;
* ``torch.tensor(...)`` / ``torch.as_tensor(...)`` with a ``device=``
  keyword — a copy from pageable host memory, which synchronises — and
  for the same reason ``.to(...)`` without ``non_blocking=True`` on a
  ``torch.from_numpy(...)`` view (the call itself, or a local name bound
  to one in the same function);
* the reference's ``np.asarray(...)``, ``float(<non-constant>)`` and
  ``block_until_ready``.

Not flagged: ``np.nonzero`` (host numpy), ``.numpy()`` alone (a CUDA
tensor's ``.numpy()`` raises rather than syncs, and ``.cpu().numpy()`` is
caught by ``.cpu()``; on the path it reads pinned host slots), and
``int(...)`` / ``bool(...)``, which the reference does not flag either and
which here only touch host keys.

What the rule cannot see: an implicit ``bool(tensor)`` in an ``if`` or a
``while``, boolean-mask indexing (``x[mask]``), both of which sync on a
CUDA tensor, and a sync inside a callee outside its scope (the rescue's
copies in ``core.packed``; the dynamic check attributes those to the
calling line in scope, where the marker goes).  ``torch.cuda.set_sync_debug_mode`` on the card reports
those (``analysis.syncs``, chip_smoke's ``syncs:`` phase); it does not
report an explicit ``Event.synchronize()`` or ``torch.cuda.synchronize()``
(torch 2.11 on the H100), which only this rule holds.

The walk is seeded from every ``stage`` / ``dispatch`` /
``dispatch_staged`` / ``join_staged`` method in ``repro_torch.serving`` and
``repro_torch.sharding`` (that covers each ``QueryEngine`` implementation,
the ``ShardRouter``, and the batcher's dispatch), follows the precise call
graph, and flags sync constructs in any reached function that lives in
those packages.  Sanctioned syncs (the quantized argmin rescue, the
synchronous ``batch``/``batch_argmin`` epilogues) carry
``# repolint: disable=hot-path-sync`` suppressions with their
justification.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from ..base import Finding, register
from ..callgraph import CallGraph, FuncInfo
from ..loader import Project

_SEED_NAMES = {"stage", "dispatch", "dispatch_staged", "join_staged"}
_SCOPE = ("repro_torch.serving", "repro_torch.sharding")


def _in_scope(mod_name: str) -> bool:
    return mod_name.startswith(_SCOPE)


def _is_name(node: ast.expr, *names: str) -> bool:
    return isinstance(node, ast.Name) and node.id in names


def _is_torch_attr(node: ast.expr, attr: str) -> bool:
    """``torch.<attr>``."""
    return isinstance(node, ast.Attribute) and node.attr == attr and \
        _is_name(node.value, "torch")


def _is_cpu(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and \
        _is_torch_attr(node.func, "device") and bool(node.args) and \
        isinstance(node.args[0], ast.Constant) and \
        node.args[0].value == "cpu"


def _is_from_numpy(node: ast.expr) -> bool:
    """``torch.from_numpy(...)``."""
    return isinstance(node, ast.Call) and \
        _is_torch_attr(node.func, "from_numpy")


def _host_views(fn: ast.AST) -> Set[str]:
    """Local names bound to ``torch.from_numpy(...)`` in ``fn`` (plain and
    tuple assignments)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            pairs = [(t, node.value)]
            if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple):
                pairs = list(zip(t.elts, node.value.elts))
            out.update(n.id for n, v in pairs
                       if isinstance(n, ast.Name) and _is_from_numpy(v))
    return out


def _blocking(call: ast.Call) -> bool:
    """No ``non_blocking=True`` keyword."""
    return not any(k.arg == "non_blocking" and
                   isinstance(k.value, ast.Constant) and k.value.value is True
                   for k in call.keywords)


def _flag(node: ast.AST, host_views: Set[str] = frozenset()) -> str:
    """Reason string if ``node`` is a sync construct, else ''.
    ``host_views``: local names bound to ``torch.from_numpy(...)``."""
    if not isinstance(node, ast.Call):
        return ""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr == "item" and not node.args and not node.keywords:
            return ".item() forces a device->host sync"
        if f.attr in ("cpu", "tolist"):
            return f".{f.attr}() copies a device value to the host"
        if f.attr == "to" and (
                any(_is_cpu(a) for a in node.args[:1]) or
                any(k.arg == "device" and _is_cpu(k.value)
                    for k in node.keywords)):
            return ".to('cpu') copies a device value to the host"
        if f.attr == "synchronize":
            return ".synchronize() blocks the host on the device"
        if f.attr == "to" and _blocking(node) and (
                _is_from_numpy(f.value) or _is_name(f.value, *host_views)):
            return (".to() of a torch.from_numpy() view without "
                    "non_blocking=True copies from pageable host memory "
                    "and synchronises")
        if f.attr == "nonzero" and not _is_name(f.value, "np", "numpy"):
            return "nonzero() has a data-dependent size: the host waits"
        if f.attr in ("tensor", "as_tensor") and _is_name(f.value, "torch") \
                and any(k.arg == "device" for k in node.keywords):
            return (f"torch.{f.attr}(..., device=) copies from pageable "
                    "host memory and synchronises")
        if f.attr == "block_until_ready":
            return "block_until_ready() blocks on device compute"
        if f.attr == "asarray" and _is_name(f.value, "np", "numpy"):
            return "np.asarray() on a device value copies to host"
    elif isinstance(f, ast.Name):
        if f.id == "float" and node.args and \
                not isinstance(node.args[0], ast.Constant):
            return "float() on a device value forces a sync"
        if f.id == "block_until_ready":
            return "block_until_ready() blocks on device compute"
    return ""


@register("hot-path-sync",
          "no .item()/.cpu()/.tolist()/.to('cpu')/.synchronize()/"
          "nonzero/pageable H2D copies/np.asarray/float() reachable "
          "from stage/dispatch/dispatch_staged/join_staged")
def check(project: Project) -> Iterator[Finding]:
    cg = CallGraph(project, precise=True)
    seeds: List[FuncInfo] = [
        fi for fi in cg.funcs.values()
        if fi.name in _SEED_NAMES and fi.cls is not None
        and _in_scope(fi.module.name)]
    if not seeds:
        return
    reach = cg.reachable(seeds)
    for qname in sorted(reach):
        fi = cg.funcs.get(qname)
        if fi is None or not _in_scope(fi.module.name):
            continue
        path = reach[qname]
        via = "" if len(path) == 1 else \
            f" (reached from {path[0]} via {' -> '.join(path[1:])})"
        views = _host_views(fi.node)
        for node in ast.walk(fi.node):
            reason = _flag(node, views)
            if reason:
                yield Finding("hot-path-sync", fi.module.path, node.lineno,
                              node.col_offset,
                              f"{reason} inside hot function "
                              f"{qname}{via}")
