"""Qwen2-VL 72B — M-RoPE VLM backbone (vision frontend stubbed).

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  The text path feeds token ids; patch embeddings
enter via ``forward(embeds=...)`` in the examples.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    rope="mrope", rope_theta=1000000.0,
    act="silu_glu", tie_embeddings=False,
)
