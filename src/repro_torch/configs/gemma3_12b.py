"""Gemma-3 12B — 5:1 local:global, 128k context, qk-norm.

[hf:google/gemma-3-1b-pt scaled family; unverified]  48L d_model=3840 16H
(GQA kv=8) d_ff=15360 vocab=262144, window 1024, every 6th layer global.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    local_window=1024, global_every=6, qk_norm=True,
    rope_theta=1000000.0,
    act="gelu_glu", tie_embeddings=True, embed_scale=True,
)
