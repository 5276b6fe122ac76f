"""Nemotron-4 340B — dense, GQA, squared-ReLU MLP. [arXiv:2402.16819;
unverified]  96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000,
    rope_theta=10000.0, act="relu2", tie_embeddings=False,
)
