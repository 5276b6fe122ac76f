"""entry-registry: every serving entry flows through ``_serving_entry``.

Cold-key counting (``core.packed.TRACES``), profile attribution
(``obs.enable_profile``) and ``PathServer.warmup()`` all key off the entry
taxonomy in ``core.packed``: an entry that bypasses
``@_serving_entry("name")`` is invisible to all three — its first live
shape is unattributed and meets a cold kernel inside the serving loop.
This is the port's counterpart of the reference's ``jit-registry``; four
sub-checks:

1. any reference to ``torch.compile``, ``torch.jit.script`` or
   ``torch.jit.trace`` in ``repro_torch.*`` is a finding (attribute
   spellings, decorators and ``from torch import compile`` alike): it
   would compile behind ``TRACES``' back;
2. the ``@_serving_entry`` decorator names must match ``SERVING_ENTRIES``
   in ``core.packed`` exactly, both directions — the static tuple is what
   tests and docs enumerate;
3. inside each decorated function, every ``TRACES.see(...)`` names the
   decorator's own entry with a literal, and there is at least one — the
   contract of ``_serving_entry``'s docstring, which the profiler's
   per-thread cold-key attribution relies on;
4. every entry's decorated function must be reachable from some
   ``warmup`` method of ``repro_torch.serving`` / ``.sharding`` (call-graph
   walk): an unreachable entry means ``PathServer.warmup()`` cannot run
   it at shape and the taxonomy has drifted from the serving surface.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..base import Finding, register
from ..callgraph import CallGraph, FuncInfo
from ..loader import Module, Project

_PACKED = "repro_torch.core.packed"
_RULE = "entry-registry"

#: (module, attribute) pairs that compile a function outside TRACES.
_COMPILERS = {("torch", "compile"), ("torch.jit", "script"),
              ("torch.jit", "trace")}


def _dotted(node: ast.expr) -> str:
    """``torch.jit`` for ``Attribute(Name('torch'), 'jit')``, else ''."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def _serving_entries(packed: Module) -> Tuple[Optional[int], Set[str]]:
    """(lineno, names) of the ``SERVING_ENTRIES`` literal, if present."""
    for node in packed.tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign):
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "SERVING_ENTRIES":
                names: Set[str] = set()
                if isinstance(value, (ast.Tuple, ast.List)):
                    for el in value.elts:
                        if isinstance(el, ast.Constant) and \
                                isinstance(el.value, str):
                            names.add(el.value)
                return node.lineno, names
    return None, set()


def _decorated_entries(cg: CallGraph) -> Dict[str, FuncInfo]:
    """entry name -> decorated function, over all ``repro_torch.*``."""
    out: Dict[str, FuncInfo] = {}
    for fi in cg.funcs.values():
        if not (fi.module.name == "repro_torch"
                or fi.module.name.startswith("repro_torch.")):
            continue
        for dec in getattr(fi.node, "decorator_list", ()):
            if not isinstance(dec, ast.Call):
                continue
            fname = ""
            if isinstance(dec.func, ast.Name):
                fname = dec.func.id
            elif isinstance(dec.func, ast.Attribute):
                fname = dec.func.attr
            if fname == "_serving_entry" and dec.args and \
                    isinstance(dec.args[0], ast.Constant):
                out[str(dec.args[0].value)] = fi
    return out


def _see_calls(fi: FuncInfo) -> Iterator[ast.Call]:
    """``TRACES.see(...)`` calls in ``fi``'s body."""
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "see" and \
                _dotted(node.func.value).rpartition(".")[2] == "TRACES":
            yield node


@register(_RULE,
          "no torch.compile/torch.jit; @_serving_entry names match "
          "SERVING_ENTRIES, report their own TRACES key and are "
          "warmup-reachable")
def check(project: Project) -> Iterator[Finding]:
    # (1) compilers behind TRACES' back
    for mod in project.in_package("repro_torch"):
        for node in ast.walk(mod.tree):
            hit = ""
            if isinstance(node, ast.Attribute) and \
                    (_dotted(node.value), node.attr) in _COMPILERS:
                hit = f"{_dotted(node.value)}.{node.attr}"
            elif isinstance(node, ast.ImportFrom) and not node.level:
                for a in node.names:
                    if (node.module, a.name) in _COMPILERS:
                        hit = f"{node.module}.{a.name}"
            if hit:
                yield Finding(_RULE, mod.path, node.lineno, node.col_offset,
                              f"{hit} compiles outside the serving entry "
                              "taxonomy; route the call through "
                              "core.packed._serving_entry so TRACES / "
                              "warmup / profile attribution see it")

    packed = project.module(_PACKED)
    if packed is None:
        return
    ent_line, declared = _serving_entries(packed)
    cg = CallGraph(project)
    decorated = _decorated_entries(cg)

    # (2) taxonomy drift, both directions
    if ent_line is None:
        yield Finding(_RULE, packed.path, 1, 0,
                      "core.packed has no SERVING_ENTRIES tuple to check "
                      "the serving entry taxonomy against")
    else:
        for name in sorted(set(decorated) - declared):
            fi = decorated[name]
            yield Finding(_RULE, fi.module.path, fi.lineno, 0,
                          f"serving entry {name!r} is not listed in "
                          f"core.packed.SERVING_ENTRIES")
        for name in sorted(declared - set(decorated)):
            yield Finding(_RULE, packed.path, ent_line, 0,
                          f"SERVING_ENTRIES lists {name!r} but no "
                          f"@_serving_entry({name!r}) definition exists")

    # (3) each entry reports its own key
    for name, fi in sorted(decorated.items()):
        calls = list(_see_calls(fi))
        if not calls:
            yield Finding(_RULE, fi.module.path, fi.lineno, 0,
                          f"serving entry {name!r} never reports its key "
                          f"with TRACES.see({name!r}, ...)")
        for call in calls:
            arg = call.args[0] if call.args else None
            if isinstance(arg, ast.Constant) and arg.value == name:
                continue
            said = repr(arg.value) if isinstance(arg, ast.Constant) else \
                "a non-literal"
            yield Finding(_RULE, fi.module.path, call.lineno,
                          call.col_offset,
                          f"TRACES.see names {said} inside serving entry "
                          f"{name!r}; the profiler attributes the cold "
                          f"key to the decorator's entry")

    # (4) warmup reachability
    seeds = [fi for fi in cg.funcs.values()
             if fi.name == "warmup" and fi.cls is not None
             and fi.module.name.startswith(("repro_torch.serving",
                                            "repro_torch.sharding"))]
    if not seeds:
        return
    reach = cg.reachable(seeds)
    for name, fi in sorted(decorated.items()):
        if fi.qname not in reach:
            yield Finding(_RULE, fi.module.path, fi.lineno, 0,
                          f"serving entry {name!r} is not reachable from "
                          f"any serving warmup(); its first live shape "
                          f"would meet a cold kernel inside the serving "
                          f"loop")
