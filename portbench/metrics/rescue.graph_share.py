"""Share of the exact-argmin rescues over the traced window that replayed
the engine's captured rescue graph: ``rescue_graph_replays_total`` over
``rescue_batches_total``.  None where nothing was rescued, or where no
rescue replayed a graph (an eager rescue, or a program that does not count
the replays)."""

NAME = "rescue.graph_share"
UNIT = "ratio"
LAYER = "serving.query_engine: exact-argmin rescue"
SOURCE = "program_counter"
MOVES = "qps"


def read(ctx):
    n = ctx.delta("rescue_batches_total")
    replays = ctx.delta("rescue_graph_replays_total")
    return replays / n if n and replays else None
