"""CLI driver for the port's repolint pass (see ``__main__`` for -m entry).

Exit status: 0 clean, 1 findings, 2 usage error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import checkers  # noqa: F401  (registers the built-in rules)
from .base import render_json, render_text, rules, run
from .loader import load_project

DEFAULT_PATHS = ("src/repro_torch",)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run the port's invariant checkers (DESIGN.md §14).")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to scan "
                         "(default: src/repro_torch)")
    ap.add_argument("--root", default=".",
                    help="repo root module names resolve against")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--select", action="append", default=None,
                    metavar="RULE",
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    try:
        ns = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if not e.code else 2

    if ns.list_rules:
        for r in rules():
            print(f"{r.name}: {r.description}")
        return 0

    paths = ns.paths or list(DEFAULT_PATHS)
    project = load_project(paths, root=ns.root)
    if not project.modules:
        print(f"no python sources found under: {' '.join(paths)}",
              file=sys.stderr)
        return 2
    try:
        findings = run(project, select=ns.select)
    except KeyError as e:
        print(str(e), file=sys.stderr)
        return 2
    out = render_json(findings) if ns.format == "json" else \
        render_text(findings)
    print(out)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
