"""Query engines, the batching PathServer and its continuous batcher."""

from .batcher import CoalescingBatcher, QueueFull, Ticket  # noqa: F401
from .engine import (BucketStats, PathServer,             # noqa: F401
                     ServeStats, expected_join_cost)
from .query_engine import (CudaEngine, HostEngine,         # noqa: F401
                           Pending, QueryEngine, TorchEngine, make_engine)
