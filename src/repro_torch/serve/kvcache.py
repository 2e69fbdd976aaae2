"""Decode-state construction (PyTorch port of the reference's
``serve/kvcache.py``: the decoder families' (dense, moe) bf16 and int8
KV caches and the ssm family's recurrent state)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               kv_dtype: str | None = None) -> dict:
    """Zero-initialized decode state, ``dtype`` bf16 by default as the
    reference's.  Dense and moe: ``{"k", "v"}``, layout ``(L, B, Tmax, KV, Dh)``;
    with ``kv_dtype="int8"`` (the reference's quantized KV cache) ``k`` and
    ``v`` are int8 and ``{"k_scale", "v_scale"}`` ``(L, B, Tmax, KV)``
    float32 hold their per-(position, head) scales.  Ssm (RWKV6):
    ``{"att_x", "ffn_x"}`` ``(L, B, 1, d)`` in ``dtype`` and ``"wkv"``
    ``(L, B, H, N, N)`` in float32; neither ``max_seq`` nor ``kv_dtype``
    shapes it, as in the reference."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"init_cache: kv_dtype {kv_dtype!r} is not 'int8' "
                         f"(other caches take their type from dtype)")
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.family == "ssm":
        d, n = cfg.d_model, cfg.rwkv_head_dim
        return {
            "att_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=dev),
            "ffn_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=dev),
            "wkv": torch.zeros((L, batch, d // n, n, n),
                               dtype=torch.float32, device=dev),
        }
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"init_cache: family {cfg.family!r} is not yet ported "
            f"(ROADMAP queue A, item 5)")
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    if kv_dtype == "int8":
        cache = {n: torch.zeros(shape, dtype=torch.int8, device=dev)
                 for n in ("k", "v")}
        cache.update({n: torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)
                      for n in ("k_scale", "v_scale")})
        return cache
    return {n: torch.zeros(shape, dtype=dtype, device=dev)
            for n in ("k", "v")}
