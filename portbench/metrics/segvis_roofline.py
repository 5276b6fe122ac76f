"""Share of its roofline that ``segvis`` reaches in the traced
sub-window: the least time the H100 needs for that sub-window's work
(``portbench.yardstick.bound_seconds``, from the served queries' own
inputs) over the device time the profiler gives the kernel."""

NAME = "segvis_roofline"
UNIT = "%"
LAYER = "kernels: segvis and label_join_rowmin"
SOURCE = "device_trace"
MOVES = "qps"


def read(ctx):
    if ctx.device_trace is None or "segvis" not in ctx.bounds:
        return None
    busy = ctx.device_trace.kernel_seconds("segvis")
    bound = ctx.bounds["segvis"]
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
