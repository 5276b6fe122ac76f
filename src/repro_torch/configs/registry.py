"""Architecture registry: ``--arch <id>`` resolution, the (arch x shape)
cell enumeration and the per-cell input stand-ins.

Each architecture lives in its own module exporting ``CONFIG`` with the
published dims.  ``input_specs`` gives meta tensors (shapes and dtypes, no
storage): the dry run's inputs.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.models.config import (LM_SHAPES, ModelConfig, ShapeSpec,
                                       shape_applicable)

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


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                device="meta") -> dict:
    """Stand-ins for every model input of this cell: int32 tokens [B, S]
    (one new token [B, 1] for decode) and, for the enc-dec family's train
    and prefill cells, bf16 encoder frames [B, enc_seq, d_model]."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=device)}
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32, device=device)}
    if cfg.encdec:
        specs["enc_frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                          dtype=torch.bfloat16, device=device)
    return specs
