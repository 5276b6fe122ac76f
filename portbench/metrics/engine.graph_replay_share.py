"""Share of the engine's device calls over the traced window that replayed
a captured CUDA graph: ``graph_replays_total`` over ``graph_replays_total``
plus ``graph_eager_calls_total`` (the calls that ran op by op).  None where
the program counts neither."""

NAME = "engine.graph_replay_share"
UNIT = "ratio"
LAYER = "serving.query_engine: device calls"
SOURCE = "program_counter"
MOVES = "qps"


def read(ctx):
    replays = ctx.delta("graph_replays_total")
    n = replays + ctx.delta("graph_eager_calls_total")
    return replays / n if n else None
