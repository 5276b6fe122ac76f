"""Share of a quantized engine's argmin rows that the exact-argmin rescue
re-answered over the traced window: ``rescue_rows_total`` over
``argmin_rows_total`` (every slot of every argmin batch joined, padding
included).  None where no argmin batch was counted."""

NAME = "rescue.rows_share"
UNIT = "ratio"
LAYER = "serving.query_engine: exact-argmin rescue"
SOURCE = "program_counter"
MOVES = "qps"


def read(ctx):
    n = ctx.delta("argmin_rows_total")
    return ctx.delta("rescue_rows_total") / n if n else None
