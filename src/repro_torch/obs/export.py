"""Exporters: Prometheus text format + JSON snapshot, and a parser (the
port's copy of ``repro.obs.export``).

``prometheus_text`` renders every series in a registry in the Prometheus
exposition format (histograms as cumulative ``_bucket``/``_sum``/
``_count`` families).  ``parse_prometheus`` inverts it strictly enough
for CI smokes to assert "the snapshot parses and series X is present"
without a prometheus client dependency.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, Tuple

from .metrics import Gauge, Histogram, MetricsRegistry

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LINE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{([^}]*)\})?"                      # optional label block
    r"\s+(-?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|[Ii]nf|NaN))$")  # value
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _esc(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels, extra: Dict[str, str] = None) -> str:
    items = list(labels) + sorted((extra or {}).items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def _fmt_val(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 2 ** 53 else repr(f)


def prometheus_text(registry: MetricsRegistry) -> str:
    lines = []
    by_name: Dict[Tuple[str, str], list] = {}
    for m in registry.metrics():
        kind = ("histogram" if isinstance(m, Histogram) else
                "gauge" if isinstance(m, Gauge) else "counter")
        by_name.setdefault((m.name, kind), []).append(m)
    for (name, kind), series in sorted(by_name.items()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid prometheus metric name: {name!r}")
        lines.append(f"# TYPE {name} {kind}")
        for m in sorted(series, key=lambda s: s.labels):
            if kind == "histogram":
                cum = 0
                for b, c in zip(m.bounds, m.counts[:-1]):
                    cum += int(c)
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(m.labels, {'le': _fmt_val(b)})}"
                        f" {cum}")
                cum += int(m.counts[-1])
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(m.labels, {'le': '+Inf'})} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(m.labels)} {_fmt_val(m.sum)}")
                lines.append(f"{name}_count{_fmt_labels(m.labels)} {cum}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(m.labels)} {_fmt_val(m.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str],
                                                        ...], float]]:
    """Parse exposition text → {name: {sorted label tuple: value}}.

    Raises ``ValueError`` on any malformed sample line, which is the CI
    assertion that the snapshot is well-formed.
    """
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _LINE_RE.match(ln)
        if m is None:
            raise ValueError(f"malformed prometheus line: {ln!r}")
        name, lblk, val = m.group(1), m.group(2) or "", m.group(3)
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\n", "\n")
             .replace("\\\\", "\\"))
            for k, v in _LABEL_RE.findall(lblk)))
        out.setdefault(name, {})[labels] = float(val)
    return out


def json_snapshot(registry: MetricsRegistry, **extra) -> str:
    snap = registry.snapshot()
    snap.update(extra)
    return json.dumps(snap, indent=1, sort_keys=True)
