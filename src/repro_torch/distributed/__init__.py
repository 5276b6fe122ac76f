"""Fault handling for training (the port of ``repro.distributed.fault``;
the mesh sharding rules come with the distributed slice)."""
from . import fault  # noqa: F401
