"""Source discovery, parsing, and the project import graph.

A :class:`Project` is the parsed view of one or more source roots: each
``.py`` file becomes a :class:`Module` carrying its AST, ``symtable``, raw
lines and resolved import edges.  Module names mirror the runtime import
system: files under a root's ``src/`` layout get their dotted package path
(``src/repro_torch/obs/events.py`` -> ``repro_torch.obs.events``); loose
scripts get ``<dirname>.<stem>`` (``benchmarks/common.py`` ->
``benchmarks.common``) so layering rules can target them by prefix.

Import edges record *what was imported*, not just from where: layering
rules need to distinguish ``from repro_torch.core import pack_bucketed``
(an ``__init__``-exported name) from ``from repro_torch.core.packed import
...`` (a deep module import).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import symtable
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    """One import statement's resolved target.

    ``module`` is the dotted module named by the statement (for ``from m
    import a, b`` that is ``m``); ``names`` the imported attributes (empty
    for plain ``import m``); ``level`` the relative-import dot count
    (already folded into ``module``); ``toplevel`` whether the statement
    executes at module import time (False for function-local imports,
    which are the sanctioned lazy escape hatch for heavy deps).
    """

    module: str
    names: Tuple[str, ...]
    lineno: int
    col: int
    toplevel: bool


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: str                   # repo-relative, slash-separated
    name: str                   # dotted module name
    source: str
    tree: ast.AST
    lines: List[str]
    imports: List[ImportEdge]
    suppressions: Dict[int, set]
    table: Optional[symtable.SymbolTable]

    @property
    def package(self) -> str:
        """``repro_torch.obs`` for ``repro_torch.obs.events``; '' for
        top-level."""
        return self.name.rpartition(".")[0]


class Project:
    """All modules reachable under the given roots, plus lookups."""

    def __init__(self, modules: List[Module]):
        self.modules = modules
        self.by_name: Dict[str, Module] = {m.name: m for m in modules}

    def module(self, name: str) -> Optional[Module]:
        return self.by_name.get(name)

    def in_package(self, prefix: str) -> List[Module]:
        """Modules whose dotted name is ``prefix`` or under it."""
        return [m for m in self.modules
                if m.name == prefix or m.name.startswith(prefix + ".")]

    def imports_of(self, module: Module,
                   toplevel_only: bool = False) -> Iterator[ImportEdge]:
        for e in module.imports:
            if toplevel_only and not e.toplevel:
                continue
            yield e


# ------------------------------------------------------------------ loading
def _module_name(root: str, relpath: str) -> str:
    """Dotted name for ``relpath`` (slash-separated, .py) under ``root``."""
    parts = relpath[:-3].split("/")          # strip .py
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_imports(tree: ast.AST, module_name: str) -> List[ImportEdge]:
    edges: List[ImportEdge] = []
    # toplevel = the statement is a direct child of the Module body (or of
    # an `if` at module scope, e.g. TYPE_CHECKING blocks)
    toplevel_nodes: set = set()
    stack = list(getattr(tree, "body", []))
    while stack:
        n = stack.pop()
        toplevel_nodes.add(id(n))
        if isinstance(n, (ast.If, ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                stack.extend(getattr(n, field, []))
            for h in getattr(n, "handlers", []):
                stack.extend(h.body)
    pkg_parts = module_name.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                edges.append(ImportEdge(a.name, (), node.lineno,
                                        node.col_offset,
                                        id(node) in toplevel_nodes))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                # resolve `from ..x import y` against this module's package
                base = pkg_parts[:-node.level] if node.level <= len(pkg_parts) \
                    else []
                mod = ".".join(base + ([mod] if mod else []))
            edges.append(ImportEdge(mod,
                                    tuple(a.name for a in node.names),
                                    node.lineno, node.col_offset,
                                    id(node) in toplevel_nodes))
    edges.sort(key=lambda e: (e.lineno, e.col))
    return edges


def load_file(path: str, root: str = ".") -> Optional[Module]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
    except (OSError, UnicodeDecodeError):
        return None
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        return None
    name = _module_name(root, rel)
    try:
        table = symtable.symtable(source, rel, "exec")
    except SyntaxError:          # pragma: no cover - parse already passed
        table = None
    from .base import _suppressions  # local: base imports loader
    mod = Module(path=rel, name=name, source=source, tree=tree,
                 lines=source.splitlines(), imports=[], suppressions={},
                 table=table)
    mod.imports = _collect_imports(tree, name)
    mod.suppressions = _suppressions(mod)
    return mod


def load_project(paths: Sequence[str], root: str = ".") -> Project:
    """Parse every ``.py`` under ``paths`` (files or directories)."""
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    mods = []
    seen = set()
    for f in sorted(files):
        m = load_file(f, root=root)
        if m is not None and m.path not in seen:
            seen.add(m.path)
            mods.append(m)
    return Project(mods)
