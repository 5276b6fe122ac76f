"""Host microseconds of copying a query's endpoints to the device: the
child spans ``engine.upload`` (the pageable host-to-device copies of each
batch's s and t) of the traced window's sync requests over their queries.
None where the program records no child spans."""

NAME = "engine.upload_us_per_query"
UNIT = "us"
LAYER = "serving.query_engine: device calls"
SOURCE = "program_span"
MOVES = "qps"
SPANS = ("engine.upload",)


def read(ctx):
    tr = [t for t in ctx.traces if t.kind == "sync" and t.attrs.get("n")]
    n = sum(t.attrs["n"] for t in tr)
    secs = [sp.seconds for t in tr for sp in getattr(t, "spans", ())
            if sp.name in SPANS]
    if not n or not secs:
        return None
    return 1e6 * sum(secs) / n
