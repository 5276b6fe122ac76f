"""Built-in checkers; importing this package registers all of them."""

from . import (entry_registry, hot_path_sync, layering,  # noqa: F401
               lock_order, monotonic_time)

__all__ = ["entry_registry", "hot_path_sync", "layering", "lock_order",
           "monotonic_time"]
