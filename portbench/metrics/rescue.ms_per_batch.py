"""Host milliseconds of one exact-argmin rescue of a quantized batch over
the traced window: ``rescue_ms`` summed over ``rescue_batches_total``."""

NAME = "rescue.ms_per_batch"
UNIT = "ms"
LAYER = "serving.query_engine: exact-argmin rescue"
SOURCE = "program_counter"
MOVES = "qps"


def read(ctx):
    n = ctx.delta("rescue_batches_total")
    return ctx.delta("rescue_ms") / n if n else None
