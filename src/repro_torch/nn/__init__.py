"""Model substrate of the port: layers, attention, LUT activation, dense
decoder."""
from .transformer import DecoderParams, init_params, param_defs

__all__ = ["DecoderParams", "init_params", "param_defs"]
