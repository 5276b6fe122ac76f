"""Host index building (numpy, float64) and the device layout + query."""

from .compression import (compress, compress_incremental,  # noqa: F401
                          compress_to_device_budget, compress_to_fraction)
from .edgegrid import (EdgeGrid, build_edge_grid,          # noqa: F401
                       gather_edge_tiles, plan_grid, segvis_grid)
from .grid import EHLIndex, build_ehl                      # noqa: F401
from .hublabel import build_hub_labels                     # noqa: F401
from .maps import make_map                                 # noqa: F401
from .packed import (LAYOUT_F32, TRACES, BucketedIndex,    # noqa: F401
                     PackedIndex, SlabLayout, bucketed_device_bytes,
                     bucketed_from_numpy, pack_bucketed, pack_index,
                     plan_buckets, query_batch, query_batch_argmin,
                     query_batch_bucketed, slab_device_bytes,
                     slab_label_slots, slab_layout)
from .query import path_length, query, unwind_path         # noqa: F401
from .visgraph import build_visgraph                       # noqa: F401
from .workload import (QuerySet, cluster_queries,         # noqa: F401
                       historical_workload, make_clusters,
                       mixed_queries, uniform_queries, workload_scores)
