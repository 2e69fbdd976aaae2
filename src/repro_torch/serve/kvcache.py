"""Decode-state construction (PyTorch port of the reference's
``serve/kvcache.py``, dense family, bf16 cache)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zero-initialized ``{"k", "v"}`` cache, layout ``(L, B, Tmax, KV,
    Dh)``, bf16 by default as the reference's."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_cache: family {cfg.family!r} is not yet ported "
            f"(ROADMAP queue A, item 7)")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {n: torch.zeros(shape, dtype=dtype, device=dev)
            for n in ("k", "v")}
