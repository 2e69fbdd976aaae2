"""Int8 error-feedback gradient compression (the reference's
``train/compression.py``, its single-device form).

Each gradient leaf is quantized to int8 against a per-leaf float32 scale,
with an error-feedback accumulator carrying what the rounding lost into
the next step.  :func:`compressed_mean_local` is the reference's
compressed data-parallel mean with one data shard: the int32 sum and the
scales' maximum over one shard are the shard's own, and the mean divides
by ``n_dp = 1``, in the reference's order of operations.  The mesh form
(``compressed_dp_mean``, int8 collectives over the data axes) waits for
sharded training (ROADMAP queue A, item 11).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 0-d)``: ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round(x / scale), -127, 127)`` (round half to even).  Both
    divisions are tensor by tensor (a true division, as XLA's)."""
    scale = torch.amax(torch.abs(x)) / x.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads: list, error: list):
    """Apply error feedback and quantize.  Returns ``(q8, scales,
    new_error)``, lists in the order of ``grads``."""
    qs, ss, es = [], [], []
    for g, e in zip(grads, error):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        qs.append(q)
        ss.append(s)
        es.append(corrected - dequantize_int8(q, s))
    return qs, ss, es


def compressed_mean_local(grads: list, error: list):
    """The compressed mean over one data shard: ``(mean, new_error)``,
    ``mean = int32(q) * scale / n_dp`` with ``n_dp = 1``."""
    n_dp = 1
    q8, scales, new_e = ef_compress_grads(grads, error)
    mean = [q.to(torch.int32).float() * s / n_dp for q, s in zip(q8, scales)]
    return mean, new_e
