"""Approximate intra-project call graph over the parsed AST.

Sound-ish and deliberately over-approximate: the hot-path and lock-order
checkers need "could f reach g", not a points-to analysis.  Resolution
strategy per call site, in decreasing precision:

1. ``name(...)``      — the enclosing module's imports and module-level
                        defs (``from repro_torch.core.packed import
                        join_masked`` binds ``join_masked`` to that
                        function);
2. ``x.meth(...)``    — when ``x`` is a local assigned from a resolvable
                        project-class constructor, or a parameter whose
                        annotation names a project class, ``meth`` within
                        that class's hierarchy;
3. ``self.meth(...)`` — ``meth`` anywhere in the enclosing class's
                        hierarchy (ancestors *and* descendants — ``self``
                        may be any subclass);
4. ``self.attr.meth`` — when any method of the class assigns ``self.attr``
                        from a project-class constructor or a typed
                        parameter, ``meth`` within that class's hierarchy
                        (this is what carries cross-module edges like
                        ``IndexManager._adapt -> SwappableEngine.swap``);
5. ``mod.fn(...)``    — when ``mod`` names an imported project module,
                        ``fn`` at that module's top level;
6. ``obj.meth(...)``  — fallback: every project function/method named
                        ``meth`` (the over-approximation that keeps
                        reachability conservative).

``precise=True`` drops step 6: callers that must not invent edges (the
lock-order checker, where a coincidental method name would fabricate a
deadlock) trade recall for zero name-collision noise.

Dunder calls other than ``__init__``/``__enter__``/``__exit__`` are not
resolved (fallback noise outweighs the coverage).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .loader import Module, Project

_RESOLVED_DUNDERS = {"__init__", "__enter__", "__exit__"}


@dataclasses.dataclass
class FuncInfo:
    """One function or method definition."""

    # "repro_torch.serving.batcher:CoalescingBatcher.submit"
    qname: str
    module: Module
    node: ast.AST               # FunctionDef | AsyncFunctionDef
    cls: Optional[str]          # enclosing class name, or None

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def lineno(self) -> int:
        return self.node.lineno


@dataclasses.dataclass
class ClassInfo:
    module: Module
    node: ast.ClassDef
    bases: List[str]            # base names as written (dotted tail)
    methods: Dict[str, FuncInfo]


class CallGraph:
    """Project-wide def tables + per-function callee resolution."""

    def __init__(self, project: Project, precise: bool = False):
        self.project = project
        self.precise = precise
        self.funcs: Dict[str, FuncInfo] = {}
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.classes: Dict[str, ClassInfo] = {}      # "module:Class"
        self.class_by_name: Dict[str, List[ClassInfo]] = {}
        self._callees: Dict[str, Set[str]] = {}
        self._attr_types_cache: Dict[str, Dict[str, str]] = {}
        for mod in project.modules:
            self._index_module(mod)
        self._subclasses = self._build_hierarchy()

    # ------------------------------------------------------------- indexing
    def _index_module(self, mod: Module) -> None:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_func(mod, node, cls=None)
            elif isinstance(node, ast.ClassDef):
                bases = [self._base_name(b) for b in node.bases]
                ci = ClassInfo(module=mod, node=node,
                               bases=[b for b in bases if b], methods={})
                key = f"{mod.name}:{node.name}"
                self.classes[key] = ci
                self.class_by_name.setdefault(node.name, []).append(ci)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        fi = self._add_func(mod, sub, cls=node.name)
                        ci.methods[sub.name] = fi

    def _add_func(self, mod: Module, node: ast.AST,
                  cls: Optional[str]) -> FuncInfo:
        qual = f"{cls}.{node.name}" if cls else node.name
        fi = FuncInfo(qname=f"{mod.name}:{qual}", module=mod, node=node,
                      cls=cls)
        self.funcs[fi.qname] = fi
        self.by_name.setdefault(node.name, []).append(fi)
        return fi

    @staticmethod
    def _base_name(node: ast.expr) -> str:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            return node.attr
        return ""

    def _build_hierarchy(self) -> Dict[str, Set[str]]:
        """class name -> transitive subclass names (project-wide)."""
        children: Dict[str, Set[str]] = {}
        for ci in self.classes.values():
            for b in ci.bases:
                children.setdefault(b, set()).add(ci.node.name)
        closed: Dict[str, Set[str]] = {}
        for name in list(children):
            seen: Set[str] = set()
            stack = [name]
            while stack:
                for c in children.get(stack.pop(), ()):
                    if c not in seen:
                        seen.add(c)
                        stack.append(c)
            closed[name] = seen
        return closed

    def hierarchy(self, cls_name: str) -> Set[str]:
        """``cls_name`` + its project ancestors and descendants, by name."""
        out = {cls_name}
        # ancestors
        frontier = [cls_name]
        while frontier:
            n = frontier.pop()
            for ci in self.class_by_name.get(n, ()):
                for b in ci.bases:
                    if b not in out:
                        out.add(b)
                        frontier.append(b)
        # descendants (of everything gathered so far, incl. ancestors'
        # other subtrees — self may be any sibling implementation)
        for n in list(out):
            out |= self._subclasses.get(n, set())
        return out

    # ----------------------------------------------------------- resolution
    def _module_bindings(self, mod: Module) -> Dict[str, List[FuncInfo]]:
        """name -> project functions bound at ``mod``'s top level."""
        out: Dict[str, List[FuncInfo]] = {}
        for e in mod.imports:
            target = self.project.module(e.module)
            for n in e.names:
                if target is not None:
                    fi = self.funcs.get(f"{target.name}:{n}")
                    if fi is not None:
                        out.setdefault(n, []).append(fi)
                    for ci in self.class_by_name.get(n, ()):
                        if ci.module is target:
                            init = ci.methods.get("__init__")
                            if init is not None:
                                out.setdefault(n, []).append(init)
                # `from pkg import name` where name re-exported by __init__
                elif e.module and self.project.module(e.module) is None:
                    pass
        for fi in self.funcs.values():
            if fi.module is mod and fi.cls is None:
                out.setdefault(fi.name, []).append(fi)
        return out

    def _ann_class(self, ann: Optional[ast.expr]) -> str:
        """Project class named by an annotation node, or ''."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.rpartition(".")[2].rpartition("[")[0] or \
                ann.value.rpartition(".")[2]
        elif isinstance(ann, ast.Name):
            name = ann.id
        elif isinstance(ann, ast.Attribute):
            name = ann.attr
        elif isinstance(ann, ast.Subscript):     # Optional[X] / list[X]
            return self._ann_class(ann.slice)
        else:
            return ""
        return name if name in self.class_by_name else ""

    def _ctor_class(self, value: ast.expr) -> str:
        """Project class constructed by ``value``, or ''.

        Sees through ``A(...) if cond else b`` / ``x or A(...)`` — the
        repo's lazy-default idiom (``obs.Telemetry() if telemetry is None
        else telemetry``) types the attribute by the constructed branch.
        """
        if isinstance(value, ast.IfExp):
            return self._ctor_class(value.body) or \
                self._ctor_class(value.orelse)
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                cname = self._ctor_class(v)
                if cname:
                    return cname
            return ""
        if not isinstance(value, ast.Call):
            return ""
        callee = value.func
        cname = ""
        if isinstance(callee, ast.Name):
            cname = callee.id
        elif isinstance(callee, ast.Attribute):
            cname = callee.attr
        return cname if cname in self.class_by_name else ""

    def _expr_type(self, fn: FuncInfo, expr: ast.expr,
                   local_types: Dict[str, str]) -> str:
        """Project class an expression evaluates to, or '' (recursive:
        folds ``self.a.b`` chains through :meth:`attr_types`)."""
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return fn.cls or ""
            return local_types.get(expr.id, "")
        if isinstance(expr, ast.Attribute):
            base_t = self._expr_type(fn, expr.value, local_types)
            if base_t:
                for cn in self.hierarchy(base_t):
                    hit = self.attr_types(cn).get(expr.attr, "")
                    if hit:
                        return hit
            return ""
        return self._ctor_class(expr)

    def _local_types(self, fn: FuncInfo) -> Dict[str, str]:
        """local var -> class name: ``x = SomeClass(...)`` assignments plus
        parameters annotated with a project class."""
        out: Dict[str, str] = {}
        args = fn.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + [x for x in (args.vararg, args.kwarg) if x]):
            cname = self._ann_class(a.annotation)
            if cname:
                out[a.arg] = cname
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign):
                cname = self._ctor_class(node.value)
                if cname:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            out[t.id] = cname
            elif isinstance(node, ast.AnnAssign) and node.target and \
                    isinstance(node.target, ast.Name):
                cname = self._ann_class(node.annotation) or \
                    (self._ctor_class(node.value) if node.value else "")
                if cname:
                    out[node.target.id] = cname
        # second pass: locals assigned from typed attribute chains
        # (``tel = self.server.telemetry``) resolve against the map so far
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Attribute):
                cname = self._expr_type(fn, node.value, out)
                if cname:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in out:
                            out[t.id] = cname
        return out

    def attr_types(self, cls_name: str) -> Dict[str, str]:
        """``self.attr`` -> class name, over the class's own methods.

        An attribute gets a type when some method assigns it from a
        project-class constructor (``self._engine = SwappableEngine(...)``)
        or from a parameter annotated with a project class
        (``def __init__(self, engine: SwappableEngine): self._e = engine``).
        Conflicting assignments drop the attribute (unknown beats wrong).
        """
        cached = self._attr_types_cache.get(cls_name)
        if cached is not None:
            return cached
        # cache the (mutable) dict up front: recursive lookups through
        # _expr_type terminate on the partial map instead of recursing
        out: Dict[str, str] = {}
        self._attr_types_cache[cls_name] = out
        dropped: Set[str] = set()

        def note(attr: str, cname: str) -> None:
            if attr in dropped:
                return
            if attr in out and out[attr] != cname:
                del out[attr]
                dropped.add(attr)
            else:
                out[attr] = cname

        for ci in self.class_by_name.get(cls_name, ()):
            for meth in ci.methods.values():
                local = self._local_types(meth)
                for node in ast.walk(meth.node):
                    targets: List[ast.expr] = []
                    value: Optional[ast.expr] = None
                    if isinstance(node, ast.Assign):
                        targets, value = node.targets, node.value
                    elif isinstance(node, ast.AnnAssign):
                        targets, value = [node.target], node.value
                    for t in targets:
                        if not (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            continue
                        if isinstance(node, ast.AnnAssign):
                            cname = self._ann_class(node.annotation)
                            if cname:
                                note(t.attr, cname)
                                continue
                        if value is None:
                            continue
                        cname = self._ctor_class(value)
                        if not cname and isinstance(value, ast.Name):
                            cname = local.get(value.id, "")
                        if cname:
                            note(t.attr, cname)
        return out

    def resolve_call(self, fn: FuncInfo, call: ast.Call,
                     bindings: Dict[str, List[FuncInfo]],
                     local_types: Dict[str, str]) -> List[FuncInfo]:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in bindings:
                return bindings[f.id]
            # constructor by class name in scope
            hits: List[FuncInfo] = []
            for ci in self.class_by_name.get(f.id, ()):
                init = ci.methods.get("__init__")
                if init is not None:
                    hits.append(init)
            return hits
        if not isinstance(f, ast.Attribute):
            return []
        meth = f.attr
        if meth.startswith("__") and meth not in _RESOLVED_DUNDERS:
            return []
        base = f.value
        if isinstance(base, ast.Name):
            if base.id == "self" and fn.cls is not None:
                return self._methods_in(self.hierarchy(fn.cls), meth)
            if base.id in local_types:
                return self._methods_in(self.hierarchy(local_types[base.id]),
                                        meth)
            # imported project module: mod.fn(...)
            target = self._imported_module(fn.module, base.id)
            if target is not None:
                fi = self.funcs.get(f"{target.name}:{meth}")
                return [fi] if fi is not None else []
        # typed attribute chains: self.attr.meth(...), x.attr.meth(...)
        if isinstance(base, ast.Attribute):
            cname = self._expr_type(fn, base, local_types)
            if cname:
                return self._methods_in(self.hierarchy(cname), meth)
        if self.precise:
            return []
        # fallback: any project def with this method name
        return list(self.by_name.get(meth, ()))

    def _imported_module(self, mod: Module, alias: str) -> Optional[Module]:
        for e in mod.imports:
            if not e.names and (e.module == alias
                                or e.module.endswith("." + alias)):
                return self.project.module(e.module)
            if e.names and alias in e.names:
                sub = f"{e.module}.{alias}" if e.module else alias
                m = self.project.module(sub)
                if m is not None:
                    return m
        return None

    def _methods_in(self, class_names: Set[str], meth: str) -> List[FuncInfo]:
        out = []
        for cn in class_names:
            for ci in self.class_by_name.get(cn, ()):
                fi = ci.methods.get(meth)
                if fi is not None:
                    out.append(fi)
        return out

    # ------------------------------------------------------------- traversal
    def callees(self, fn: FuncInfo) -> Set[str]:
        """qnames of functions ``fn`` may call (cached)."""
        cached = self._callees.get(fn.qname)
        if cached is not None:
            return cached
        bindings = self._module_bindings(fn.module)
        local_types = self._local_types(fn)
        out: Set[str] = set()
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                for callee in self.resolve_call(fn, node, bindings,
                                                local_types):
                    out.add(callee.qname)
        self._callees[fn.qname] = out
        return out

    def reachable(self, seeds: List[FuncInfo]) -> Dict[str, List[str]]:
        """qname -> one call path from a seed, for every reachable func."""
        paths: Dict[str, List[str]] = {}
        frontier: List[Tuple[FuncInfo, List[str]]] = \
            [(s, [s.qname]) for s in seeds]
        for s, p in frontier:
            paths.setdefault(s.qname, p)
        while frontier:
            fn, path = frontier.pop()
            for q in self.callees(fn):
                if q in paths:
                    continue
                nxt = self.funcs.get(q)
                if nxt is None:
                    continue
                paths[q] = path + [q]
                frontier.append((nxt, path + [q]))
        return paths

    def iter_calls(self, fn: FuncInfo) -> Iterator[ast.Call]:
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                yield node
