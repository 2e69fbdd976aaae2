"""Model substrate of the port: layers, attention, LUT activation, the
decoder (dense, moe, vlm), RWKV6 and the Griffin hybrid."""
from .transformer import (
    DecoderParams,
    HybridParams,
    RWKVParams,
    init_params,
    param_defs,
)

__all__ = ["DecoderParams", "HybridParams", "RWKVParams", "init_params",
           "param_defs"]
