"""Llama-4 Scout 17B-active/16E — MoE, early fusion (text backbone).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, 16 routed experts top-1 + 1 shared.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    moe=True, n_experts=16, topk=1, n_shared=1, moe_d_ff=8192,
    n_dense_layers=0, router="sigmoid",
    rope_theta=500000.0, act="silu_glu", tie_embeddings=False,
)
