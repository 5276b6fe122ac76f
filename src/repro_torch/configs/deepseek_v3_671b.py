"""DeepSeek-V3 671B — MLA + 1 shared / 256 routed top-8 MoE + MTP.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(moe expert)=2048
vocab=129280; first 3 layers dense (d_ff=18432); MLA: q_lora 1536,
kv_lora 512, qk_nope 128, qk_rope 64, v 128.
"""

from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=18432, vocab=129280,
    attn="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=True, n_experts=256, topk=8, n_shared=1, moe_d_ff=2048,
    n_dense_layers=3, router="sigmoid", mtp=True,
    act="silu_glu", tie_embeddings=False,
)
