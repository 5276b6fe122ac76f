"""Whisper large-v3 — enc-dec audio backbone (conv frontend stubbed).

[arXiv:2212.04356; unverified]  32L decoder + 32L encoder, d_model=1280
20H d_ff=5120 vocab=51866; encoder sees 1500 precomputed frame embeddings
(the frontend is a stub).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866,
    encdec=True, enc_layers=32, enc_seq=1500,
    rope="rope", act="gelu", tie_embeddings=True,
)
