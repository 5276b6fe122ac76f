"""Seconds the benchmark's own clock gives the host index (built, or
loaded from the checkout's cache) and ``pack_bucketed`` onto the card."""

NAME = "setup.index_s"
UNIT = "s"
LAYER = "core: host index and packing"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(ctx):
    return ctx.setup_index_s
