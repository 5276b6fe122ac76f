"""lock-order: the static lock-acquisition graph matches LOCK_RANKS.

The serving/indexing/obs mesh takes locks from four subsystems on one
request path (batcher condition -> engine pin -> registry -> event log);
an AB/BA inversion between any two of them is a deadlock that only
manifests under a hostile scheduler.  This checker builds the
acquisition graph statically and fails CI on any inversion:

* every lock in the monitored modules (``repro_torch.serving.batcher``,
  ``repro_torch.indexing.{swap,manager,recorder}`` and ``repro_torch.obs``)
  must be created through ``repro_torch.obs.locks.make_lock("<name>")``
  with a literal name that has a declared rank in ``LOCK_RANKS``
  (``threading.Condition(self._lock)`` wrapping a made lock is fine and
  aliases its rank);
* each ``with self._lock:`` site maps to its rank; while a lock is held,
  every directly nested ``with`` and every lock transitively acquired by
  a (precisely resolved, cross-module) callee must have a strictly
  greater rank;
* independent of ranks, any cycle in the acquisition graph is reported.

``repro_torch.kernels`` is outside the monitored set, as ``repro.kernels``
is in the reference: the module-level ``threading.Lock()`` of
``kernels/build.py`` serialises nvcc builds and ctypes loads, and the only
locks taken under it are the leaves its build counters take
(``obs.registry``, ``obs.series``).

The same partial order is asserted at runtime by
``repro_torch.obs.locks.OrderedLock`` when ``REPRO_LOCK_CHECK=1`` — the
static pass catches inversions on paths the stress tests never
interleave; the sanitizer catches acquisitions the precise call graph
cannot see.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..base import Finding, register
from ..callgraph import CallGraph, FuncInfo
from ..loader import Module, Project

_LOCKS_MODULE = "repro_torch.obs.locks"

#: Modules where every lock must go through make_lock.
_MONITORED = ("repro_torch.serving.batcher", "repro_torch.indexing.swap",
              "repro_torch.indexing.manager",
              "repro_torch.indexing.recorder", "repro_torch.obs")


def _monitored(mod_name: str) -> bool:
    if mod_name == _LOCKS_MODULE:
        return False
    return any(mod_name == m or mod_name.startswith(m + ".")
               for m in _MONITORED)


def _ranks(project: Project) -> Dict[str, int]:
    locks = project.module(_LOCKS_MODULE)
    if locks is None:
        return {}
    for node in locks.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "LOCK_RANKS" and \
                    isinstance(value, ast.Dict):
                out: Dict[str, int] = {}
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(v, ast.Constant):
                        out[str(k.value)] = int(v.value)
                return out
    return {}


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


@dataclasses.dataclass(frozen=True)
class _Edge:
    src: str                    # lock name held
    dst: str                    # lock name acquired under it
    path: str
    line: int
    via: str                    # '' for direct nesting, else callee qname


class _LockIndex:
    """Maps ``self.attr`` / module globals to make_lock names."""

    def __init__(self, project: Project, cg: CallGraph,
                 ranks: Dict[str, int]):
        self.cg = cg
        self.ranks = ranks
        self.attr: Dict[Tuple[str, str], str] = {}   # (class, attr) -> name
        self.globals: Dict[Tuple[str, str], str] = {}  # (module, var) -> name
        self.findings: List[Finding] = []
        # two passes so Condition(self._lock) sees the lock mapping;
        # only the final pass's findings survive (no duplicates)
        for _ in range(2):
            self.findings.clear()
            for mod in project.modules:
                self._scan_module_body(mod)
            for ci in cg.classes.values():
                for meth in ci.methods.values():
                    self._scan_method(ci.module, ci.node.name, meth)

    # -------------------------------------------------------------- scanning
    def _lock_name_of(self, mod: Module, value: ast.expr,
                      cls: Optional[str]) -> Optional[str]:
        """make_lock name produced by ``value``, or None."""
        if not isinstance(value, ast.Call):
            return None
        name = _call_name(value)
        if name == "make_lock":
            if value.args and isinstance(value.args[0], ast.Constant):
                lit = str(value.args[0].value)
                if lit not in self.ranks:
                    self.findings.append(Finding(
                        "lock-order", mod.path, value.lineno,
                        value.col_offset,
                        f"make_lock({lit!r}) has no declared rank in "
                        f"repro_torch.obs.locks.LOCK_RANKS"))
                return lit
            self.findings.append(Finding(
                "lock-order", mod.path, value.lineno, value.col_offset,
                "make_lock() requires a literal lock name so the static "
                "order checker can rank it"))
            return None
        if name == "Condition" and value.args:
            inner = value.args[0]
            if isinstance(inner, ast.Attribute) and \
                    isinstance(inner.value, ast.Name) and \
                    inner.value.id == "self" and cls is not None:
                return self._attr_lock(cls, inner.attr)
        return None

    def _raw_lock(self, mod: Module, value: ast.expr,
                  cls: Optional[str]) -> bool:
        """True if ``value`` creates a raw threading lock (monitored)."""
        if not (isinstance(value, ast.Call) and _monitored(mod.name)):
            return False
        name = _call_name(value)
        if name in ("Lock", "RLock"):
            return True
        if name == "Condition":
            # Condition wrapping a made lock aliases its rank; bare
            # Condition() (own hidden RLock) is raw.
            return self._lock_name_of(mod, value, cls) is None
        return False

    def _scan_assign(self, mod: Module, cls: Optional[str],
                     targets: List[ast.expr], value: ast.expr) -> None:
        lock = self._lock_name_of(mod, value, cls)
        if lock is None and self._raw_lock(mod, value, cls):
            self.findings.append(Finding(
                "lock-order", mod.path, value.lineno, value.col_offset,
                "raw threading lock in an order-monitored module; create "
                "it with repro_torch.obs.locks.make_lock(\"<ranked "
                "name>\")"))
            return
        if lock is None:
            return
        for t in targets:
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and cls is not None:
                self.attr[(cls, t.attr)] = lock
            elif isinstance(t, ast.Name):
                if cls is None:
                    self.globals[(mod.name, t.id)] = lock

    def _scan_module_body(self, mod: Module) -> None:
        for node in mod.tree.body:
            if isinstance(node, ast.Assign):
                self._scan_assign(mod, None, node.targets, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._scan_assign(mod, None, [node.target], node.value)

    def _scan_method(self, mod: Module, cls: str, meth: FuncInfo) -> None:
        for node in ast.walk(meth.node):
            if isinstance(node, ast.Assign):
                self._scan_assign(mod, cls, node.targets, node.value)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                self._scan_assign(mod, cls, [node.target], node.value)

    # -------------------------------------------------------------- lookups
    def _attr_lock(self, cls: str, attr: str) -> Optional[str]:
        for cn in self.cg.hierarchy(cls):
            hit = self.attr.get((cn, attr))
            if hit is not None:
                return hit
        return None

    def resolve(self, fn: FuncInfo, expr: ast.expr,
                local_locks: Dict[str, str]) -> Optional[str]:
        """Lock name acquired by ``with <expr>:``, or None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            if expr.value.id == "self" and fn.cls is not None:
                return self._attr_lock(fn.cls, expr.attr)
            return self.globals.get((fn.module.name, expr.attr)) if \
                expr.value.id != "self" else None
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return local_locks[expr.id]
            return self.globals.get((fn.module.name, expr.id))
        return None


@register("lock-order",
          "lock acquisition graph is acyclic and follows LOCK_RANKS")
def check(project: Project) -> Iterator[Finding]:
    ranks = _ranks(project)
    cg = CallGraph(project, precise=True)
    index = _LockIndex(project, cg, ranks)
    yield from index.findings

    # local `x = make_lock("n")` bindings, per function
    def local_locks(fn: FuncInfo) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _call_name(node.value) == "make_lock" and \
                    node.value.args and \
                    isinstance(node.value.args[0], ast.Constant):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = str(node.value.args[0].value)
        return out

    # ---- pass 1: direct acquires per function, then transitive fixpoint
    direct: Dict[str, Set[str]] = {}
    for fn in cg.funcs.values():
        locs = local_locks(fn)
        acq: Set[str] = set()
        for node in ast.walk(fn.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    name = index.resolve(fn, item.context_expr, locs)
                    if name is not None:
                        acq.add(name)
        direct[fn.qname] = acq

    trans: Dict[str, Set[str]] = {q: set(a) for q, a in direct.items()}
    changed = True
    while changed:
        changed = False
        for fn in cg.funcs.values():
            cur = trans[fn.qname]
            before = len(cur)
            for c in cg.callees(fn):
                cur |= trans.get(c, set())
            if len(cur) != before:
                changed = True

    # ---- pass 2: emit held->acquired edges with source sites
    edges: Dict[Tuple[str, str], _Edge] = {}

    def note(src: str, dst: str, fn: FuncInfo, line: int,
             via: str = "") -> None:
        key = (src, dst)
        if key not in edges:
            edges[key] = _Edge(src, dst, fn.module.path, line, via)

    def walk(fn: FuncInfo, node: ast.AST, held: List[str],
             locs: Dict[str, str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                walk(fn, item.context_expr, held, locs)
            acquired = []
            for item in node.items:
                name = index.resolve(fn, item.context_expr, locs)
                if name is not None:
                    for h in held + acquired:
                        note(h, name, fn, item.context_expr.lineno)
                    acquired.append(name)
            inner = held + acquired
            for stmt in node.body:
                walk(fn, stmt, inner, locs)
            return
        if isinstance(node, ast.Call) and held:
            for callee in cg.resolve_call(fn, node, cg._module_bindings(
                    fn.module), cg._local_types(fn)):
                for dst in trans.get(callee.qname, ()):
                    for h in held:
                        note(h, dst, fn, node.lineno, via=callee.qname)
        for child in ast.iter_child_nodes(node):
            walk(fn, child, held, locs)

    for fn in cg.funcs.values():
        walk(fn, fn.node, [], local_locks(fn))

    # ---- validation: rank inversions + cycles
    for (src, dst), e in sorted(edges.items()):
        via = f" via {e.via}" if e.via else ""
        if src == dst:
            yield Finding("lock-order", e.path, e.line, 0,
                          f"lock {src!r} acquired while already held"
                          f"{via}; self-deadlock on a non-reentrant lock")
            continue
        rs, rd = ranks.get(src), ranks.get(dst)
        if rs is not None and rd is not None and rs >= rd:
            yield Finding("lock-order", e.path, e.line, 0,
                          f"rank inversion: {dst!r} (rank {rd}) acquired "
                          f"while holding {src!r} (rank {rs}){via}; "
                          f"LOCK_RANKS requires strictly increasing ranks")

    # cycles (covers unranked fixtures; ranked cycles already contain an
    # inversion but reporting the cycle names the full loop)
    adj: Dict[str, Set[str]] = {}
    for (src, dst) in edges:
        if src != dst:
            adj.setdefault(src, set()).add(dst)
    seen: Set[str] = set()
    reported: Set[Tuple[str, ...]] = set()
    for start in sorted(adj):
        if start in seen:
            continue
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack:
            node_name, path = stack.pop()
            seen.add(node_name)
            for nxt in sorted(adj.get(node_name, ())):
                if nxt in path:
                    cyc = tuple(sorted(path[path.index(nxt):]))
                    if cyc in reported:
                        continue
                    reported.add(cyc)
                    e = edges[(node_name, nxt)]
                    loop = " -> ".join(path[path.index(nxt):] + [nxt])
                    yield Finding("lock-order", e.path, e.line, 0,
                                  f"lock acquisition cycle: {loop}")
                else:
                    stack.append((nxt, path + [nxt]))
