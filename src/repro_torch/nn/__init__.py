"""Model substrate of the port: layers, attention, LUT activation, dense
decoder, RWKV6."""
from .transformer import DecoderParams, RWKVParams, init_params, param_defs

__all__ = ["DecoderParams", "RWKVParams", "init_params", "param_defs"]
