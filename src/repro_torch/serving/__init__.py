"""Query engines, the batching PathServer and its continuous batcher, and
the LM decode server."""

from .batcher import CoalescingBatcher, QueueFull, Ticket  # noqa: F401
from .engine import (BucketStats, LMServer, PathServer,   # noqa: F401
                     ServeStats, expected_join_cost)
from .query_engine import (CudaEngine, HostEngine,         # noqa: F401
                           Pending, QueryEngine, TorchEngine, make_engine)
