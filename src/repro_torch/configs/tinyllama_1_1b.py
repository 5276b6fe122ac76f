"""TinyLlama 1.1B — llama2-family dense. [arXiv:2401.02385; hf]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000,
    rope_theta=10000.0, act="silu_glu", tie_embeddings=False,
)
