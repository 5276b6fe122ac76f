"""Architecture registry: ``--arch <id>`` resolution and the (arch x shape)
cell enumeration.

Each architecture lives in its own module exporting ``CONFIG`` with the
published dims.  The per-cell input stand-ins of the reference registry
(``input_specs``) belong with the dry run and are not ported here.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import LM_SHAPES, ModelConfig, shape_applicable

ARCH_IDS = (
    "llama4-scout-17b-a16e",
    "deepseek-v3-671b",
    "tinyllama-1.1b",
    "nemotron-4-340b",
    "gemma2-27b",
    "gemma3-12b",
    "hymba-1.5b",
    "mamba2-780m",
    "qwen2-vl-72b",
    "whisper-large-v3",
)

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch]}")
    return mod.CONFIG


def all_cells():
    """Yield (arch, shape, runs, reason) for the 10 x 4 cell matrix."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for shape in LM_SHAPES:
            runs, reason = shape_applicable(cfg, shape)
            yield a, shape, runs, reason
