"""The distributed half of the LM stack (the port of
``repro.distributed``): ``compat.make_mesh`` (every LM ``DeviceMesh``),
``sharding`` (the per-architecture spec table and its DTensor
placements), ``hints`` (activation redistribution on a mesh, the identity
off it), ``moe_ep`` (expert-parallel MoE over an explicit all-to-all),
``flash_decode`` (decode over a sequence-sharded KV cache), ``pipeline``
(GPipe over the ``pod`` axis) and ``fault`` (step guard, stragglers)."""
from . import fault  # noqa: F401
