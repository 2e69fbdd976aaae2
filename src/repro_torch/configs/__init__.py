"""Architecture registry of the PyTorch port (own copy of the reference's
``configs`` package for the architectures it serves).

The port serves ``qwen3-0.6b`` (dense decoder-only) and ``rwkv6-3b``
(ssm); the reference's other architectures are listed by name so that
asking for one fails with a clear message instead of a ``KeyError``.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig, MoEConfig

from . import qwen3_0_6b, rwkv6_3b

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (qwen3_0_6b, rwkv6_3b)}

# Architectures of the reference the port does not serve yet, with their
# family (ROADMAP queue A, item 5).
NOT_PORTED: dict[str, str] = {
    "nemotron-4-15b": "dense",
    "phi4-mini-3.8b": "dense",
    "deepseek-67b": "dense",
    "deepseek-moe-16b": "moe",
    "qwen3-moe-30b-a3b": "moe",
    "phi-3-vision-4.2b": "vlm",
    "recurrentgemma-9b": "hybrid",
    "whisper-small": "encdec",
}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} (family {NOT_PORTED[name]!r}) is not yet ported "
            f"to repro_torch: it serves {ARCH_NAMES} (ROADMAP queue A, "
            f"item 5)")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant (2 layers, d_model 64) for CPU tests."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"smoke_config: family {cfg.family!r} is not yet ported")
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        n_frames=cfg.n_frames,
        n_encoder_layers=0,
        n_patches=0,
        d_rnn=None,
        local_window=8 if cfg.local_window else None,
        rwkv_head_dim=16,
        max_seq_len=256,
    )
    if cfg.family == "ssm":
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 4
    return dataclasses.replace(cfg, **kw)


__all__ = ["ArchConfig", "MoEConfig", "REGISTRY", "ARCH_NAMES",
           "get_config", "smoke_config"]
