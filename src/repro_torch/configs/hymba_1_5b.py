"""Hymba 1.5B — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.  Sub-quadratic (runs long_500k).
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    local_window=1024, global_every=16,   # hymba: most layers SWA + few global
    ssm=SSMConfig(state_dim=16, head_dim=50, n_heads=32, expand=2,
                  chunk=128, conv_width=4),
    act="silu_glu", tie_embeddings=True,
)
