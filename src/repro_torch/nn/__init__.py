"""Model substrate of the port: layers, attention, LUT activation, the
decoder (dense, moe, vlm), RWKV6, the Griffin hybrid and Whisper."""
from .transformer import (
    DecoderParams,
    EncDecParams,
    HybridParams,
    RWKVParams,
    init_params,
    param_defs,
)

__all__ = ["DecoderParams", "EncDecParams", "HybridParams", "RWKVParams",
           "init_params", "param_defs"]
