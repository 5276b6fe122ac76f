"""Device bytes of the packed artifact (``device_bytes()``), in MiB."""

NAME = "index.device_mib"
UNIT = "MiB"
LAYER = "core.packed: the device artifact"
SOURCE = "program_counter"
MOVES = "peak_mem_mib"


def read(ctx):
    return ctx.index_device_bytes / 2 ** 20 if ctx.index_device_bytes \
        else None
