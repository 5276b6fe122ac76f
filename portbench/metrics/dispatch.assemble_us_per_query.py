"""Host microseconds of assembling a query's batches: the child spans
``batch.assemble`` (a bucket's rows selected and padded into the fixed
[B, 2] arrays) and ``batch.scatter`` (the answers written back in request
order, the bucket counters) of the traced window's sync requests over
their queries.  None where the program records no child spans."""

NAME = "dispatch.assemble_us_per_query"
UNIT = "us"
LAYER = "serving.engine: host routing and batch assembly"
SOURCE = "program_span"
MOVES = "qps"
SPANS = ("batch.assemble", "batch.scatter")


def read(ctx):
    tr = [t for t in ctx.traces if t.kind == "sync" and t.attrs.get("n")]
    n = sum(t.attrs["n"] for t in tr)
    secs = [sp.seconds for t in tr for sp in getattr(t, "spans", ())
            if sp.name in SPANS]
    if not n or not secs:
        return None
    return 1e6 * sum(secs) / n
