"""Unified model configuration covering the 10 assigned architectures.

One frozen dataclass parameterises every family: dense / MoE (incl. MLA) /
SSM (mamba2 SSD) / hybrid (parallel attn+SSM) / enc-dec (whisper) / VLM
backbone (M-RoPE).  ``reduced()`` returns the CPU-smoke-test scale of the
same family (same code paths, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD dims (state-space duality block)."""
    state_dim: int = 128         # N
    head_dim: int = 64           # P
    n_heads: int = 24            # d_inner / P
    expand: int = 2
    chunk: int = 128             # SSD block length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # attention flavour
    attn: str = "gqa"            # gqa | mla | none
    mla: Optional[MLAConfig] = None
    local_window: int = 0        # sliding-window size for local layers
    global_every: int = 0        # k -> layers with (l+1) % k == 0 are global
    softcap_attn: float = 0.0    # gemma2 attn-logit softcap
    softcap_logits: float = 0.0  # gemma2 final-logit softcap
    rope_theta: float = 10000.0
    rope: str = "rope"           # rope | mrope | none
    qk_norm: bool = False

    # mlp flavour
    act: str = "silu_glu"        # silu_glu | gelu_glu | gelu | relu2

    # MoE
    moe: bool = False
    n_experts: int = 0
    topk: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0      # leading dense layers (deepseek: 3)
    router: str = "softmax"      # softmax | sigmoid
    capacity_factor: float = 1.25
    mtp: bool = False            # deepseek multi-token-prediction head

    # SSM / hybrid
    ssm: Optional[SSMConfig] = None

    # enc-dec (whisper): decoder uses the fields above; encoder below
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500          # whisper: 30 s of 100 Hz frames, conv-stub /2

    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma: embeddings * sqrt(d_model)
    norm_eps: float = 1e-6
    remat: str = "full"          # full | none — activation checkpoint policy

    # lowering controls (roofline calibration sets unroll_layers=True with
    # single-block attention/CE so XLA's while-body-counted-once
    # cost_analysis sees every flop; production uses scan + chunking)
    unroll_layers: bool = False
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    ce_chunk: int = 512

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM/hybrid state decode)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch has an autoregressive decoder

    def layer_is_global(self, l: int) -> bool:
        if self.local_window == 0:
            return True
        if self.global_every <= 0:
            return False
        return (l + 1) % self.global_every == 0

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, H, K, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        per_layer = 0
        if self.attn == "gqa":
            per_layer += d * H * hd + 2 * d * K * hd + H * hd * d
        elif self.attn == "mla":
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += (d * m.q_lora_rank + m.q_lora_rank * H * qk
                          + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                          + m.kv_lora_rank * H * (m.qk_nope_head_dim
                                                  + m.v_head_dim)
                          + H * m.v_head_dim * d)
        if self.ssm is not None:
            s = self.ssm
            d_in = s.n_heads * s.head_dim
            # in_proj emits (z, x, B, C, dt): B/C are group-shared [N], not
            # per-head; + depthwise conv + out_proj
            per_layer += d * (2 * d_in + 2 * s.state_dim + s.n_heads) \
                + d_in * d + s.conv_width * (d_in + 2 * s.state_dim) \
                + 3 * s.n_heads + d_in
        n_moe_layers = 0
        dense_ffn = lambda ff: (3 if "glu" in self.act else 2) * self.d_model * ff
        if self.moe:
            n_moe_layers = self.n_layers - self.n_dense_layers
            per_expert = dense_ffn(self.moe_d_ff)
            moe_per_layer = (self.n_experts + self.n_shared) * per_expert \
                + self.d_model * self.n_experts
            total_ffn = (self.n_dense_layers * dense_ffn(self.d_ff)
                         + n_moe_layers * moe_per_layer)
        else:
            total_ffn = self.n_layers * dense_ffn(self.d_ff)
        total = self.n_layers * (per_layer + 2 * self.d_model) + total_ffn
        total += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        if self.encdec:
            enc_layer = 4 * d * d + dense_ffn(self.d_ff) + 2 * d
            total += self.enc_layers * enc_layer + self.n_layers * 4 * d * d
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        dense_ffn = lambda ff: (3 if "glu" in self.act else 2) * self.d_model * ff
        n_moe_layers = self.n_layers - self.n_dense_layers
        inactive = n_moe_layers * (self.n_experts - self.topk) \
            * dense_ffn(self.moe_d_ff)
        return int(full - inactive)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        if self.mla:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=8, qk_rope_head_dim=8,
                                  v_head_dim=8)
        if self.ssm:
            kw["ssm"] = SSMConfig(state_dim=16, head_dim=8, n_heads=4,
                                  expand=2, chunk=16, conv_width=4)
        kw.update(n_layers=min(self.n_layers, 4) if not self.moe else 2,
                  d_model=64,
                  n_heads=4 if self.n_heads else 0,
                  n_kv_heads=2 if self.n_kv_heads else 0,
                  head_dim=16 if self.n_heads else 0,
                  d_ff=128, vocab=256,
                  local_window=8 if self.local_window else 0,
                  global_every=self.global_every and 2,
                  n_experts=4 if self.moe else 0,
                  topk=min(self.topk, 2), n_shared=min(self.n_shared, 1),
                  moe_d_ff=64 if self.moe else 0,
                  # no token dropping at smoke scale: decode == forward
                  capacity_factor=8.0 if self.moe else self.capacity_factor,
                  n_dense_layers=min(self.n_dense_layers, 1),
                  enc_layers=2 if self.encdec else 0,
                  enc_seq=32 if self.encdec else 0)
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell: what gets lowered in the dry-run."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


LM_SHAPES = (
    ShapeSpec("train_4k", "train", 4096, 256),
    ShapeSpec("prefill_32k", "prefill", 32768, 32),
    ShapeSpec("decode_32k", "decode", 32768, 128),
    ShapeSpec("long_500k", "decode", 524288, 1),
)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason) — which (arch, shape) cells run."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention global layers: 524k-token KV exceeds "
                       "pod HBM and attention is quadratic — skipped")
    return True, ""
