"""Model zoo in PyTorch: the unified decoder/enc-dec of the 10 assigned
architectures, serving half (prefill, cache, decode)."""
from .config import (LM_SHAPES, MLAConfig, ModelConfig, ShapeSpec,  # noqa: F401
                     SSMConfig, shape_applicable)
from .transformer import (TransformerLM, cache_from_numpy,  # noqa: F401
                          decode_step, encode, forward, init_cache,
                          init_params, params_from_numpy, prefill)
