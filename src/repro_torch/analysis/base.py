"""Checker framework: findings, registry, suppressions, reporters.

A checker is a callable over the parsed :class:`~repro_torch.analysis.
loader.Project` that yields :class:`Finding` objects.  The driver collects
findings from every (selected) checker, drops the ones suppressed by
``# repolint: disable=<rule>`` comments, and renders the rest as text or
JSON.  Exit status is nonzero iff any finding survives — the pass is a
blocking CI step, so every rule here is an *invariant*, not a style nit
(DESIGN.md §14).

Suppression syntax (checked per finding against the finding's file/line):

* trailing, on the flagged line::

      t0 = time.time()   # repolint: disable=monotonic-time  -- wall ts

* on the immediately preceding line (for long flagged lines)::

      # repolint: disable=hot-path-sync -- rescue is a sanctioned sync
      flags = bool(np.asarray(res[5]).any())

* file-level, anywhere in the first comment block of the module::

      # repolint: disable-file=jit-registry -- offline tool, never served

Everything after ``--`` is the human justification; the checker framework
requires the marker but does not parse the prose.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional

from .loader import Module, Project

_SUPPRESS_RE = re.compile(
    r"#\s*repolint:\s*(disable|disable-file)=([A-Za-z0-9_,\- ]+)")

#: Lines scanned for file-level ``disable-file`` markers.
_FILE_SCOPE_LINES = 40


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation at a source location."""

    rule: str
    path: str               # repo-relative path
    line: int               # 1-indexed
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered checker."""

    name: str
    description: str
    check: Callable[[Project], Iterator[Finding]]


_RULES: Dict[str, Rule] = {}


def register(name: str, description: str):
    """Decorator registering ``fn(project) -> Iterator[Finding]``."""

    def deco(fn: Callable[[Project], Iterator[Finding]]):
        if name in _RULES:
            raise ValueError(f"duplicate checker name {name!r}")
        _RULES[name] = Rule(name=name, description=description, check=fn)
        return fn

    return deco


def rules() -> List[Rule]:
    return [_RULES[k] for k in sorted(_RULES)]


def get_rule(name: str) -> Rule:
    try:
        return _RULES[name]
    except KeyError:
        raise KeyError(f"unknown checker {name!r}; known: "
                       f"{', '.join(sorted(_RULES))}") from None


# --------------------------------------------------------------- suppression
def _suppressions(module: Module) -> Dict[int, set]:
    """line -> set of rule names disabled on that line (0 = whole file)."""
    out: Dict[int, set] = {}
    for i, text in enumerate(module.lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        # everything after `--` is the justification, not a rule name
        spec = m.group(2).split("--", 1)[0]
        names = {n.strip() for n in spec.split(",") if n.strip()}
        if m.group(1) == "disable-file":
            if i <= _FILE_SCOPE_LINES:
                out.setdefault(0, set()).update(names)
        else:
            out.setdefault(i, set()).update(names)
    return out


def suppressed(module: Module, finding: Finding) -> bool:
    sup = module.suppressions
    if finding.rule in sup.get(0, ()):  # file-level
        return True
    if finding.rule in sup.get(finding.line, ()):
        return True
    # marker on the line immediately above the flagged line
    return finding.rule in sup.get(finding.line - 1, ())


# -------------------------------------------------------------------- driver
def run(project: Project,
        select: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the (selected) checkers; returns surviving findings, sorted."""
    chosen = rules() if select is None else [get_rule(n) for n in select]
    out: List[Finding] = []
    by_path = {m.path: m for m in project.modules}
    for rule in chosen:
        for f in rule.check(project):
            mod = by_path.get(f.path)
            if mod is not None and suppressed(mod, f):
                continue
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def render_text(findings: List[Finding]) -> str:
    lines = [f.render() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)


def render_json(findings: List[Finding]) -> str:
    return json.dumps({"findings": [f.to_dict() for f in findings],
                       "count": len(findings)}, indent=2)
