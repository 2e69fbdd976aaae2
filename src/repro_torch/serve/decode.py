"""Prefill and single-token decode (PyTorch port of the dense path of the
reference's ``serve/decode.py``).

``prefill(params, cfg, batch)`` -> (last-token logits, KV cache)
``decode_step(params, cfg, cache, tokens, pos)`` -> (logits, cache)

``pos`` is a Python int.  ``decode_step`` writes the new K/V entries into
``cache`` in place and returns the same dict.
"""
from __future__ import annotations

import torch

from repro_torch import sites
from repro_torch.configs.base import ArchConfig
from repro_torch.nn.layers import embed_lookup, rms_norm
from repro_torch.nn.mlp import mlp_block, project_logits, site_act
from repro_torch.nn.transformer import _decode_attn, decoder_forward

from .kvcache import init_cache


def _require_dense(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not yet ported to "
            f"repro_torch (ROADMAP queue A, item 7)")


@torch.no_grad()
def prefill(params, cfg: ArchConfig, batch: dict, max_seq: int | None = None,
            lut_tables=None):
    """Run the prompt ``batch["tokens"]`` (B, T); the cache holds
    ``max_seq`` positions (default T) in the model dtype, as the
    reference's padded prefill cache does."""
    _require_dense(cfg, "prefill")
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
def decode_step(params, cfg: ArchConfig, cache: dict, tokens: torch.Tensor,
                pos: int, lut_tables=None):
    """One greedy-decode step for tokens (B, 1) at position ``pos``."""
    _require_dense(cfg, "decode_step")
    if "k_scale" in cache:
        raise NotImplementedError(
            "decode_step: the int8 KV cache (and prefill_replay) is not "
            "yet ported (ROADMAP queue A, item 4)")
    x = embed_lookup(params.embed, tokens)
    for i in range(cfg.n_layers):
        p = params.layer(i)
        rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, i)
        x = x + _decode_attn(p, rms_norm(x, p["ln1"], cfg.norm_eps, rs),
                             cfg, cache["k"][i], cache["v"][i], pos,
                             lut_tables=lut_tables, layer=i)
        hin = rms_norm(x, p["ln2"], cfg.norm_eps, rs)
        x = x + mlp_block(p, hin, cfg, lut_tables, layer=i)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return project_logits(x, params.lm_head, cfg, lut_tables), cache
