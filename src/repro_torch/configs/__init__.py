"""Architecture registry of the PyTorch port (own copy of the reference's
``configs`` package): the reference's ten architectures, every one
served, in the reference's order.

Dense: ``nemotron-4-15b``, ``phi4-mini-3.8b``, ``deepseek-67b``,
``qwen3-0.6b``; moe: ``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``; vlm:
``phi-3-vision-4.2b`` (the dense decoder after a stubbed image prefix);
ssm: ``rwkv6-3b``; hybrid: ``recurrentgemma-9b`` (RG-LRU and local
attention); encdec: ``whisper-small`` (a bidirectional encoder over
stubbed audio frames, a decoder with cross-attention).
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MoEConfig

from . import (
    deepseek_67b,
    deepseek_moe_16b,
    nemotron_4_15b,
    phi4_mini_3_8b,
    phi_3_vision_4_2b,
    qwen3_0_6b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    rwkv6_3b,
    whisper_small,
)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        nemotron_4_15b, phi4_mini_3_8b, deepseek_67b, qwen3_0_6b,
        deepseek_moe_16b, qwen3_moe_30b_a3b, phi_3_vision_4_2b,
        rwkv6_3b, recurrentgemma_9b, whisper_small,
    )
}

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant (2 layers, d_model 64; moe: 8 experts
    top-2 at d_expert 32; vlm: 4 patches; hybrid: 4 layers, one group of
    the pattern and a one-layer tail, d_rnn 64, window 8; encdec: 2
    encoder layers over 16 frames) for CPU tests, the reference's
    ``smoke_config``."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        n_frames=16 if cfg.family == "encdec" else cfg.n_frames,
        n_encoder_layers=2 if cfg.family == "encdec" else 0,
        n_patches=4 if cfg.family == "vlm" else 0,
        d_rnn=64 if cfg.family == "hybrid" else None,
        local_window=8 if cfg.local_window else None,
        rwkv_head_dim=16,
        max_seq_len=256,
    )
    if cfg.family == "ssm":
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4
    if cfg.moe:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            # effectively dropless at smoke scale so decode == forward
            capacity_factor=8.0,
        )
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "MoEConfig", "REGISTRY", "ARCH_NAMES",
           "get_config", "smoke_config"]
