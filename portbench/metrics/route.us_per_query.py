"""Host microseconds of routing a query to its dispatch bucket: the
``route`` stage of the traced window's sync requests over their queries."""

NAME = "route.us_per_query"
UNIT = "us"
LAYER = "serving.engine: host routing and batch assembly"
SOURCE = "program_span"
MOVES = "qps"


def read(ctx):
    tr = [t for t in ctx.traces if t.kind == "sync" and t.attrs.get("n")]
    n = sum(t.attrs["n"] for t in tr)
    if not n:
        return None
    return 1e6 * sum(t.stages.get("route", 0.0) for t in tr) / n
