"""Gemma-2 27B — local/global alternating attention + logit softcaps.

[arXiv:2408.00118; hf]  46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000, window 4096 on local layers, every 2nd layer global,
attn softcap 50, final-logit softcap 30.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    local_window=4096, global_every=2,
    softcap_attn=50.0, softcap_logits=30.0,
    act="gelu_glu", tie_embeddings=True, embed_scale=True,
)
