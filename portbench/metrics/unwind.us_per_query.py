"""Host microseconds of unwinding a polyline from its winning labels: the
``unwind`` stage of the traced window's ``query_paths`` requests over their
queries."""

NAME = "unwind.us_per_query"
UNIT = "us"
LAYER = "serving.engine: host unwind"
SOURCE = "program_span"
MOVES = "qps"


def read(ctx):
    tr = [t for t in ctx.traces if t.kind == "sync" and t.attrs.get("n")
          and t.attrs.get("argmin")]
    n = sum(t.attrs["n"] for t in tr)
    if not n:
        return None
    return 1e6 * sum(t.stages.get("unwind", 0.0) for t in tr) / n
