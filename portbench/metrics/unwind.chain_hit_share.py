"""Share of the chain lookups of the traced window's ``query_paths`` rows
that the host unwind's chain table answered without walking the labels:
1 - ``unwind_chain_fills_total`` / (2 · ``unwind_rows_total``), two chains a
row (via_s up to the hub, the hub down to via_t), the fills being the chains
walked to build a table.  1 where every table was built before the window;
None where no row was unwound, or the program keeps no such table."""

NAME = "unwind.chain_hit_share"
UNIT = "ratio"
LAYER = "serving.engine: host unwind"
SOURCE = "program_counter"
MOVES = "qps"


def read(ctx):
    rows = ctx.delta("unwind_rows_total")
    if not rows:
        return None
    return 1.0 - ctx.delta("unwind_chain_fills_total") / (2 * rows)
