"""Query engines and the batching PathServer."""

from .engine import BucketStats, PathServer, ServeStats    # noqa: F401
from .query_engine import (CudaEngine, HostEngine,         # noqa: F401
                           QueryEngine, TorchEngine, make_engine)
