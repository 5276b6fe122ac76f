"""Per-architecture configs (exact published dims)."""

from .registry import (ARCH_IDS, all_cells, get_config,  # noqa: F401
                       input_specs)
