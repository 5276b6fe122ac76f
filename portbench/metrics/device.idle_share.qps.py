"""Share of the traced sub-window in which no operation ran on the device
(from the profiler's device events, overlaps counted once)."""

NAME = "device.idle_share.qps"
UNIT = "ratio"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "qps"


def read(ctx):
    dt = ctx.device_trace
    if dt is None or dt.busy_s <= 0:
        return None
    return 1.0 - dt.busy_s / dt.window_s
