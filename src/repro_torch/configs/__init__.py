"""Architecture registry of the PyTorch port (own copy of the reference's
``configs`` package for the architectures it serves).

The port serves ``qwen3-0.6b`` (dense decoder-only), ``rwkv6-3b`` (ssm),
``deepseek-moe-16b`` and ``qwen3-moe-30b-a3b`` (moe),
``phi-3-vision-4.2b`` (vlm: the dense decoder after a stubbed image
prefix) and ``recurrentgemma-9b`` (hybrid: RG-LRU and local attention);
the reference's four other architectures are listed by name so that
asking for one fails with a clear message instead of a ``KeyError``.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MoEConfig

from . import (
    deepseek_moe_16b,
    phi_3_vision_4_2b,
    qwen3_0_6b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    rwkv6_3b,
)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_0_6b, deepseek_moe_16b, qwen3_moe_30b_a3b,
              phi_3_vision_4_2b, rwkv6_3b, recurrentgemma_9b)}

PORTED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")

# Architectures of the reference the port does not serve yet, with their
# family (ROADMAP queue A, item 5).
NOT_PORTED: dict[str, str] = {
    "nemotron-4-15b": "dense",
    "phi4-mini-3.8b": "dense",
    "deepseek-67b": "dense",
    "whisper-small": "encdec",
}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} (family {NOT_PORTED[name]!r}) is not yet ported "
            f"to repro_torch: it serves {ARCH_NAMES}; the four still "
            f"waiting are {sorted(NOT_PORTED)} (ROADMAP queue A, item 5)")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant (2 layers, d_model 64; moe: 8 experts
    top-2 at d_expert 32; vlm: 4 patches; hybrid: 4 layers, one group of
    the pattern and a one-layer tail, d_rnn 64, window 8) for CPU tests,
    the reference's ``smoke_config``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"smoke_config: family {cfg.family!r} is not yet ported; the "
            f"four architectures still waiting are {sorted(NOT_PORTED)} "
            f"(ROADMAP queue A, item 5)")
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        n_frames=cfg.n_frames,
        n_encoder_layers=0,
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
