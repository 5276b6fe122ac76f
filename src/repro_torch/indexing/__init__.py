"""Adaptive index lifecycle: live workload capture -> budgeted recompression
-> zero-downtime hot-swap (DESIGN.md §8), on the port's packers and engines.

The paper's workload-aware EHL* assumes the query distribution is known
offline; this subsystem discovers it from live traffic and keeps the serving
artifact re-optimized under a device-byte budget:

* :class:`WorkloadRecorder` — decayed per-cell endpoint histogram (bounded
  memory, O(1) per query) that ``PathServer`` and its batcher feed;
* :class:`BudgetPlanner`   — drift detection + incremental-vs-replan policy
  over ``core.compression``'s resumable merge loop;
* :class:`SwappableEngine` — generation-counted double-buffered engine
  indirection (in-flight requests drain on the old artifact);
* :class:`IndexManager`    — orchestration: build off the serving path,
  probe-set validation, atomic swap.
"""

from .recorder import WorkloadRecorder                      # noqa: F401
from .planner import BudgetPlanner, PlanDecision            # noqa: F401
from .swap import SwappableEngine                           # noqa: F401
from .manager import (IndexManager, SwapRecord,             # noqa: F401
                      engine_answers)
