"""Checkpoints and the EHL index cache (the port of ``repro.checkpoint``)."""
from . import store  # noqa: F401
from .store import load_ehl_index, save_ehl_index  # noqa: F401
