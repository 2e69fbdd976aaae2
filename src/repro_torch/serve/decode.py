"""Prefill and single-token decode (PyTorch port of the dense, moe and
ssm paths of the reference's ``serve/decode.py``).

``prefill(params, cfg, batch)`` -> (last-token logits, decode state)
``decode_step(params, cfg, cache, tokens, pos)`` -> (logits, cache)
``prefill_replay(params, cfg, cache, tokens, start_pos)`` -> (last-token
logits, cache)

``pos`` is a Python int or a 0-d integer tensor on the cache's device
(the form a step captured in a CUDA graph reads, :mod:`.graphs`); both
give the same bits, and nothing in a decode step reads a tensor back to
the host.  ``decode_step`` updates ``cache`` in place (the new K/V
entries, quantized for an int8 cache, or the recurrent state) and returns
the same dict.  The family picks the functions, as the reference's
``PREFILL_FNS`` / ``DECODE_FNS`` do.
"""
from __future__ import annotations

import torch

from repro_torch import sites
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.layers import embed_lookup, rms_norm
from repro_torch.nn.mlp import project_logits, site_act
from repro_torch.nn.transformer import (
    _decode_attn,
    decoder_forward,
    feed_forward,
    rwkv_forward,
)

from .kvcache import init_cache


@torch.no_grad()
def decoder_prefill(params, cfg: ArchConfig, batch: dict,
                    max_seq: int | None = None, lut_tables=None):
    """Run the prompt ``batch["tokens"]`` (B, T); the cache holds
    ``max_seq`` positions (default T) in the model dtype, as the
    reference's padded prefill cache does."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    cache = init_cache(cfg, b, max(max_seq or t, t),
                       dtype=params.embed.dtype, device=tokens.device)

    def sink(i, k, v):
        cache["k"][i, :, :t] = k
        cache["v"][i, :, :t] = v

    x, _ = decoder_forward(params, cfg, tokens, lut_tables=lut_tables,
                           kv_sink=sink)
    logits = project_logits(x[:, -1:], params.lm_head, cfg, lut_tables)
    return logits, cache


@torch.no_grad()
def decoder_decode_step(params, cfg: ArchConfig, cache: dict,
                        tokens: torch.Tensor, pos, lut_tables=None):
    """One greedy-decode step for tokens (B, 1) at position ``pos``; an
    int8 cache (``"k_scale"`` in it) is written quantized and read
    dequantized."""
    int8 = "k_scale" in cache
    x = embed_lookup(params.embed, tokens)
    for i in range(cfg.n_layers):
        p = params.layer(i)
        rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, i)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if int8 else None
        x = x + _decode_attn(p, rms_norm(x, p["ln1"], cfg.norm_eps, rs),
                             cfg, cache["k"][i], cache["v"][i], pos,
                             scales=scales, lut_tables=lut_tables, layer=i)
        hin = rms_norm(x, p["ln2"], cfg.norm_eps, rs)
        x = x + feed_forward(p, hin, cfg, lut_tables, layer=i)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return project_logits(x, params.lm_head, cfg, lut_tables), cache


@torch.no_grad()
def rwkv_prefill(params, cfg: ArchConfig, batch: dict,
                 max_seq: int | None = None, lut_tables=None):
    """Run the prompt through RWKV6 from a zero state; returns the
    last-token logits and the segment-final state (att_x / ffn_x in the
    model dtype, wkv in float32)."""
    tokens = batch["tokens"]
    state = init_cache(cfg, tokens.shape[0], 1, dtype=params.embed.dtype,
                       device=tokens.device)
    x, state = rwkv_forward(params, cfg, tokens, states=state,
                            lut_tables=lut_tables)
    logits = project_logits(x[:, -1:], params.lm_head, cfg, lut_tables)
    return logits, state


@torch.no_grad()
def rwkv_decode_step(params, cfg: ArchConfig, cache: dict,
                     tokens: torch.Tensor, pos, lut_tables=None):
    """One RWKV6 decode step for tokens (B, 1); ``pos`` is not needed."""
    x, cache = rwkv_forward(params, cfg, tokens, states=cache,
                            lut_tables=lut_tables)
    return project_logits(x, params.lm_head, cfg, lut_tables), cache


PREFILL_FNS = {"dense": decoder_prefill, "moe": decoder_prefill,
               "ssm": rwkv_prefill}
DECODE_FNS = {"dense": decoder_decode_step, "moe": decoder_decode_step,
              "ssm": rwkv_decode_step}


def _family_fn(table: dict, cfg: ArchConfig, what: str):
    fn = table.get(cfg.family)
    if fn is None:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not yet ported to "
            f"repro_torch (ROADMAP queue A, item 5)")
    return fn


def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int | None = None,
            lut_tables=None):
    """Run the prompt ``batch["tokens"]`` (B, T) through the family's
    prefill: ``(last-token logits, decode state)``."""
    return _family_fn(PREFILL_FNS, cfg, "prefill")(
        params, cfg, batch, max_seq, lut_tables=lut_tables)


def decode_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                pos, lut_tables=None):
    """One greedy-decode step for tokens (B, 1) at position ``pos`` (a
    Python int or a 0-d integer tensor on the cache's device)."""
    return _family_fn(DECODE_FNS, cfg, "decode_step")(
        params, cfg, cache, tokens, pos, lut_tables=lut_tables)


def prefill_replay(params, cfg: ArchConfig, cache: dict,
                   tokens: torch.Tensor, start_pos: int = 0, lut_tables=None,
                   step=None):
    """Replay a (B, T) prompt through the single-token decode step at
    positions ``start_pos .. start_pos + T - 1``: ``(last-token logits
    (B, 1, V), cache)``, the cache updated in place (the reference's
    ``prefill_replay``, which scans the step).

    The decode write path quantizes, so replaying into an int8 KV cache
    gives exactly the entries (values and scales) steady-state decode
    writes, and the served LUT tables run during ingestion as during
    decode.  ``step`` is the step to replay through, ``(cache, tokens,
    pos) -> (logits, cache)``; by default :func:`.graphs.decode_fn`'s:
    captured in a CUDA graph on the card, eager on the CPU."""
    t = tokens.shape[1]
    if t < 1:
        raise ValueError("prefill_replay: the prompt has no tokens")
    if step is None:
        from .graphs import decode_fn

        step = decode_fn(params, cfg, lut_tables)
    for i in range(t):
        logits, cache = step(cache, tokens[:, i:i + 1], start_pos + i)
    # a captured step's logits are its graph's output buffer, which the
    # next replay overwrites
    return logits.clone(), cache
