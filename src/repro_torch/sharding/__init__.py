"""Sharded serving: region-sharded bucket slabs over devices (DESIGN.md §9).

For maps whose *budgeted* artifact still exceeds one card's memory, the
index is placed rather than shrunk further:

* :class:`ShardPlanner`       — byte-balanced, locality-aware region ->
  shard placement (Morton-order bin-pack + bounded rebalance);
* :class:`ShardedIndex`       — per-shard ``BucketedIndex`` slabs, each on
  its own device, plus the host-side (cell) -> (shard, bucket, row)
  routing table;
* :class:`ShardedQueryEngine` — the ``QueryEngine`` routing
  per-(shard, bucket) sub-batches over the devices with cross-shard label
  gathers, answers bitwise-identical to the single-device engine;
* :class:`ShardStats`         — per-shard occupancy/latency counters,
  surfaced through ``ServeStats.per_shard``.

The dispatch mechanics live in :mod:`repro_torch.serving.shard_router`,
the placement in :mod:`repro_torch.launch.mesh`.
"""

from .planner import (ShardPlan, ShardPlanner, ShardedIndex,  # noqa: F401
                      region_centroids, sharded_overhead_bytes)
from .engine import (ShardStats, ShardedQueryEngine,  # noqa: F401
                     shard_imbalance)
