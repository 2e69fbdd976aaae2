"""Shared building blocks: norms, projections, embeddings, activations
(PyTorch port of the reference's ``nn/layers.py``, same operation order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sharding import reduce_from_tp


# The dry run's hill-climbing lever (the reference's FAST_STREAM,
# repro_torch.launch.hillclimb): when True, norms and rope keep the
# residual stream in its own dtype and use float32 only inside reductions,
# and decode scores are rounded to the stream dtype, removing float32
# round trips.  The default (False) is the float32 path every cell is
# first measured with.
FAST_STREAM = False


def set_fast_stream(on: bool) -> None:
    global FAST_STREAM
    FAST_STREAM = on


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             rsqrt_fn=None) -> torch.Tensor:
    """RMS norm in float32 (under :data:`FAST_STREAM` float32 only in the
    mean); ``rsqrt_fn`` overrides the inverse square root (the norm-rsqrt
    LUT site) — ``None`` keeps the exact ``torch.rsqrt``."""
    rsqrt = torch.rsqrt if rsqrt_fn is None else rsqrt_fn
    dt = x.dtype
    if FAST_STREAM:
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        inv = rsqrt(var + eps).to(dt)
        return x * inv * (1.0 + scale.to(dt))
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


def embed_lookup_tp(embed: torch.Tensor, tokens: torch.Tensor,
                    vocab_start: int) -> torch.Tensor:
    """The vocab-parallel :func:`embed_lookup`: ``embed`` holds this
    rank's rows ``vocab_start ..`` of the table; a masked local take
    (zeros for a token another rank owns), summed over the model axis
    (:func:`~repro_torch.nn.sharding.reduce_from_tp`).  One rank adds its
    row to zeros, so the result is the whole table's row bit for bit."""
    idx = tokens - vocab_start
    mine = (idx >= 0) & (idx < embed.shape[0])
    rows = embed[torch.where(mine, idx, 0)]
    return reduce_from_tp(torch.where(mine[..., None], rows, 0.0))


def logits_projection(x: torch.Tensor, lm_head: torch.Tensor
                      ) -> torch.Tensor:
    """(B, T, d) @ (d, V)."""
    return torch.matmul(x, lm_head)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """Mean cross-entropy in float32: logsumexp minus the picked logit,
    then the mean (the reference's order)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)
