"""Mamba-2 780M — attention-free SSD. [arXiv:2405.21060; unverified]
48L d_model=1536 vocab=50280, state N=128, expand 2 (d_inner 3072,
head P=64 -> 48 ssd heads).  Sub-quadratic (runs long_500k)."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    attn="none", rope="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, n_heads=48, expand=2,
                  chunk=256, conv_width=4),
    act="silu_glu", tie_embeddings=True,
)
