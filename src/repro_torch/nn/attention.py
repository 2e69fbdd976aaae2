"""Attention: causal GQA, query-chunked (PyTorch port of the dense path of
the reference's ``nn/attention.py``).

Plain tensor ops in the reference's order: scores and the value
contraction accumulate in float32 (bf16 operands are widened, so every
product is exact as under ``preferred_element_type=float32``), softmax in
float32.  GQA never expands K/V to query heads: queries reshape to
(B, T, KV, H/KV, Dh) and contract against (B, T, KV, Dh) directly.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def masked_softmax(s: torch.Tensor, exp_fn=None) -> torch.Tensor:
    """Softmax over the last axis of NEG_INF-masked f32 scores.

    With ``exp_fn`` (the attention-exp LUT site) the exponential runs on
    max-shifted scores; masked entries are re-zeroed after the lookup and
    fully-masked rows give zeros instead of NaN."""
    if exp_fn is None:
        return torch.softmax(s, dim=-1)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = exp_fn(s - m)
    e = torch.where(s > NEG_INF * 0.5, e, torch.zeros_like(e))
    tot = torch.sum(e, dim=-1, keepdim=True)
    return torch.where(tot > 0, e / tot, torch.zeros_like(e))


def _chunk_scores(qc, k, v, pos_q, pos_k, *, causal, scale, exp_fn=None):
    """qc: (B, Cq, KV, G, Dh); k/v: (B, Tk, KV, Dh); pos_q (Cq,), pos_k
    (Tk,) absolute positions (pos < 0 => invalid key)."""
    s = torch.einsum("bqkgd,btkd->bkgqt", qc.float(), k.float()) * scale
    mask = (pos_k[None, :] >= 0)
    if causal:
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
    p = masked_softmax(s, exp_fn)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def mha(q, k, v, *, causal: bool = True, q_offset: int = 0,
        chunk_q: int = 512, exp_fn=None) -> torch.Tensor:
    """q: (B, Tq, H, Dh); k/v: (B, Tk, KV, Dh).  Returns (B, Tq, H, Dh)."""
    b, tq, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = dh ** -0.5
    qg = q.reshape(b, tq, kv, g, dh)
    pos_k = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, tq, chunk_q):
        qc = qg[:, c0:c0 + chunk_q]
        pos_q = torch.arange(qc.shape[1], device=q.device) + q_offset + c0
        outs.append(_chunk_scores(qc, k, v, pos_q, pos_k, causal=causal,
                                  scale=scale, exp_fn=exp_fn))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, tq, h, dh)


def decode_attend(q, k_cache, v_cache, pos: int, exp_fn=None
                  ) -> torch.Tensor:
    """Single-token decode against a full cache (entries > pos masked).
    q: (B, 1, H, Dh); caches (B, Tmax, KV, Dh)."""
    b, tmax, kvh, dh = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k_cache.float())
    s = s * (dh ** -0.5)
    valid = torch.arange(tmax, device=q.device)[None] <= pos
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG_INF))
    p = masked_softmax(s, exp_fn)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float()).to(q.dtype)
    return out.reshape(b, 1, h, dh)
