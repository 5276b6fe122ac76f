"""layering: the port's import graph respects the subsystem boundaries.

Four rules:

* ``repro_torch.obs`` must be importable without torch at module scope —
  the obs layer runs in collectors, exporters and the launch CLI, where
  torch may be absent; function-local torch imports are the sanctioned
  lazy escape (``obs/profile.py`` uses them);
* ``repro_torch.core`` never imports ``repro_torch.serving`` /
  ``.indexing`` / ``.sharding`` — core is the leaf layer; a core->serving
  edge makes the pack/join code untestable in isolation and invites
  import cycles;
* no module of ``repro_torch`` imports ``jax``, ``jaxlib``, ``ml_dtypes``
  or the reference package ``repro``, at any scope — the card's machine
  has none of them, and the port keeps its own copy of what it needs;
* ``benchmarks/`` never deep-imports past a ``repro_torch`` package
  ``__init__`` — the package exports are the supported API surface.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from ..base import Finding, register
from ..loader import Module, Project

_FOREIGN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _is(module: str, top: str) -> bool:
    return module == top or module.startswith(top + ".")


def _exported_names(mod: Module) -> Set[str]:
    """Names bound at ``mod``'s top level (incl. ``__all__`` entries)."""
    out: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in node.targets) and \
                    isinstance(node.value, (ast.List, ast.Tuple)):
                for el in node.value.elts:
                    if isinstance(el, ast.Constant) and \
                            isinstance(el.value, str):
                        out.add(el.value)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    for e in mod.imports:
        out.update(e.names)
        if not e.names:          # plain `import x.y` binds `x`
            out.add(e.module.split(".")[0])
    return out


@register("layering",
          "obs stays torch-free at module scope; core never imports "
          "serving/indexing/sharding; no jax or repro anywhere; "
          "benchmarks use package exports only")
def check(project: Project) -> Iterator[Finding]:
    # obs: no toplevel torch
    for mod in project.in_package("repro_torch.obs"):
        for e in project.imports_of(mod, toplevel_only=True):
            if _is(e.module, "torch"):
                yield Finding("layering", mod.path, e.lineno, e.col,
                              "repro_torch.obs must stay importable "
                              "without torch at module scope; import "
                              "torch inside the function that needs it")

    # core: never serving/indexing/sharding, even lazily
    for mod in project.in_package("repro_torch.core"):
        for e in mod.imports:
            if e.module.startswith(("repro_torch.serving",
                                    "repro_torch.indexing",
                                    "repro_torch.sharding")):
                yield Finding("layering", mod.path, e.lineno, e.col,
                              f"repro_torch.core must not import "
                              f"{e.module} (core is the leaf layer; "
                              "invert the dependency)")

    # the port: no jax / jaxlib / ml_dtypes / repro, at any scope
    for mod in project.in_package("repro_torch"):
        for e in mod.imports:
            hit = next((top for top in _FOREIGN if _is(e.module, top)), "")
            if hit:
                yield Finding("layering", mod.path, e.lineno, e.col,
                              f"repro_torch must not import {e.module} "
                              f"(the port runs without {hit}; keep a "
                              "copy of what it needs)")

    # benchmarks: package exports only
    for mod in project.in_package("benchmarks"):
        for e in mod.imports:
            if not _is(e.module, "repro_torch"):
                continue
            target = project.module(e.module)
            if target is None:
                # not under the scanned roots (e.g. src/ not given);
                # a dotted submodule name is still detectably deep
                if e.module.count(".") >= 2:
                    yield Finding("layering", mod.path, e.lineno, e.col,
                                  f"benchmark deep-imports {e.module}; "
                                  "import from the package __init__ "
                                  "exports instead")
                continue
            if not target.path.endswith("__init__.py"):
                yield Finding("layering", mod.path, e.lineno, e.col,
                              f"benchmark deep-imports {e.module}; "
                              "import from the package __init__ exports "
                              "instead")
                continue
            exported = _exported_names(target)
            for n in e.names:
                if n == "*" or n in exported:
                    continue
                # `from repro_torch import serving`-style subpackage pulls
                if project.module(f"{e.module}.{n}") is not None:
                    continue
                yield Finding("layering", mod.path, e.lineno, e.col,
                              f"benchmark imports {n!r} which "
                              f"{e.module}.__init__ does not export")
