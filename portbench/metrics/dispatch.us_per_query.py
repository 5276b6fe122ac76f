"""Host microseconds of dispatching a query: the ``dispatch`` stage of the
traced window's sync requests (per bucket, the fixed-shape batches: their
assembly, the device calls and the copy of the answers back) over their
queries."""

NAME = "dispatch.us_per_query"
UNIT = "us"
LAYER = "serving.engine: host routing and batch assembly"
SOURCE = "program_span"
MOVES = "qps"


def read(ctx):
    tr = [t for t in ctx.traces if t.kind == "sync" and t.attrs.get("n")]
    n = sum(t.attrs["n"] for t in tr)
    if not n:
        return None
    return 1e6 * sum(t.stages.get("dispatch", 0.0) for t in tr) / n
