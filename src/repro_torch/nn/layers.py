"""Shared building blocks: norms, projections, embeddings, activations
(PyTorch port of the reference's ``nn/layers.py``, same operation order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             rsqrt_fn=None) -> torch.Tensor:
    """RMS norm in float32; ``rsqrt_fn`` overrides the inverse square root
    (the norm-rsqrt LUT site) — ``None`` keeps the exact ``torch.rsqrt``."""
    rsqrt = torch.rsqrt if rsqrt_fn is None else rsqrt_fn
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def activation_fn(name: str):
    if name == "relu2":           # nemotron squared-ReLU
        return lambda x: torch.square(F.relu(x))
    if name in ("gelu", "geglu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("silu", "swiglu"):
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def is_gated(name: str) -> bool:
    """Gated MLPs (two input projections: gate * up)."""
    return name in ("swiglu", "geglu")


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def logits_projection(x: torch.Tensor, lm_head: torch.Tensor
                      ) -> torch.Tensor:
    """(B, T, d) @ (d, V)."""
    return torch.matmul(x, lm_head)
