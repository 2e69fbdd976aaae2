"""Rotary position embeddings (PyTorch port of the reference's
``nn/rope.py``: full head, configurable theta)."""
from __future__ import annotations

import math

import torch


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sin_fn=None) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: broadcastable to (..., T).

    ``sin_fn`` overrides the sine (the rope-table LUT site, tabulated over
    one wrapped period); the cosine reuses it a quarter period ahead.
    Under :data:`~repro_torch.nn.layers.FAST_STREAM` the rotation runs in
    ``x``'s dtype (the angles stay float32)."""
    from .layers import FAST_STREAM

    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs          # (..., T, Dh/2)
    if sin_fn is None:
        cos = torch.cos(angles)[..., None, :]              # (..., T, 1, Dh/2)
        sin = torch.sin(angles)[..., None, :]
    else:
        pi = torch.tensor(math.pi, dtype=torch.float32)
        tau = 2.0 * pi
        sin = sin_fn(torch.remainder(angles, tau))[..., None, :]
        cos = sin_fn(torch.remainder(angles + 0.5 * pi, tau))[..., None, :]
    if FAST_STREAM:
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
