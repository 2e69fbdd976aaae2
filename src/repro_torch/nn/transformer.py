"""Dense decoder-only model (PyTorch port of the dense path of the
reference's ``nn/transformer.py``).

:class:`DecoderParams` holds the parameters under the reference's names
and stacked ``(L, …)`` layouts (``embed``, ``final_norm``, ``lm_head`` and
``blocks.{wq, wk, wv, wo, q_norm, k_norm, ln1, ln2, w_in, w_out}``), so a
reference parameter tree copies in without renaming
(:func:`repro_torch.bridge.params_from_jax`).  The forward runs an eager
Python loop over layers with a Python-int layer id.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch import sites
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .attention import decode_attend, mha
from .layers import embed_lookup, is_gated, rms_norm
from .mlp import mlp_block, site_act
from .rope import apply_rope


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    scale: float = 1.0


def param_defs(cfg: ArchConfig) -> dict:
    """Names and shapes of the dense decoder's parameters (the reference's
    ``param_defs`` for ``family == "dense"``)."""
    if cfg.family != "dense" or cfg.moe:
        raise NotImplementedError(
            f"param_defs: family {cfg.family!r} is not yet ported "
            f"(ROADMAP queue A, item 7)")
    L, d = cfg.n_layers, cfg.d_model
    ff_in = 2 * cfg.d_ff if is_gated(cfg.activation) else cfg.d_ff
    blocks = {
        "wq": ParamDef((L, d, cfg.q_dim)),
        "wk": ParamDef((L, d, cfg.kv_dim)),
        "wv": ParamDef((L, d, cfg.kv_dim)),
        "wo": ParamDef((L, cfg.q_dim, d)),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = ParamDef((L, cfg.d_head), 0.0)
        blocks["k_norm"] = ParamDef((L, cfg.d_head), 0.0)
    blocks["ln1"] = ParamDef((L, d), 0.0)
    blocks["ln2"] = ParamDef((L, d), 0.0)
    blocks["w_in"] = ParamDef((L, d, ff_in))
    blocks["w_out"] = ParamDef((L, cfg.d_ff, d))
    return {
        "embed": ParamDef((cfg.vocab_size, d)),
        "final_norm": ParamDef((d,), 0.0),
        "lm_head": ParamDef((d, cfg.vocab_size)),
        "blocks": blocks,
    }


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderParams(nn.Module):
    """Dense decoder parameters (serving: no gradients)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        dt = torch_dtype(cfg.dtype)
        defs = param_defs(cfg)
        for name, d in defs.items():
            if name != "blocks":
                setattr(self, name, _param(d.shape, dt, dev))
        self.blocks = nn.ParameterDict(
            {k: _param(d.shape, dt, dev) for k, d in defs["blocks"].items()})

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as views into the stacks."""
        return {k: v[i] for k, v in self.blocks.items()}


def init_params(cfg: ArchConfig, seed: int = 0, device=None
                ) -> DecoderParams:
    """Random parameters from ``seed`` with the reference's distributions:
    zeros for scale-0 vectors, ``N(0, 0.02 * scale)`` for vectors and
    narrow matrices, and a normal truncated at +-2 scaled by
    ``scale / sqrt(fan_in)`` otherwise.  The bits differ from the
    reference's (another generator); :mod:`repro_torch.bridge` copies
    reference parameters in exactly."""
    params = DecoderParams(cfg, device)
    dev = params.embed.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    defs = param_defs(cfg)
    flat = [(n, d) for n, d in defs.items() if n != "blocks"]
    flat += [(f"blocks.{n}", d) for n, d in defs["blocks"].items()]
    named = dict(params.named_parameters())
    with torch.no_grad():
        for name, d in flat:
            t = named[name]
            if d.scale == 0.0:
                t.zero_()
                continue
            v = torch.empty(d.shape, dtype=torch.float32, device=dev)
            if len(d.shape) == 1 or (d.shape[-1] <= 64 and len(d.shape) == 2):
                v.normal_(0.0, 0.02 * d.scale, generator=gen)
            else:
                fan_in = d.shape[-2]
                nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
                v.mul_(d.scale / math.sqrt(fan_in))
            t.copy_(v)
    return params


# =========================================================================
# attention sub-block
# =========================================================================
def _qkv(p, x, cfg):
    b, t, _ = x.shape
    q = torch.matmul(x, p["wq"]).reshape(b, t, cfg.n_heads, cfg.d_head)
    k = torch.matmul(x, p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    v = torch.matmul(x, p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_apply(p, x, cfg, *, pos_offset: int = 0, lut_tables=None,
                layer: int | None = None):
    """Causal self-attention over a segment; returns (out, (k, v))."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    positions = torch.arange(t, device=x.device) + pos_offset
    sin_fn = site_act(cfg, lut_tables, sites.ROPE, layer)
    q = apply_rope(q, positions, cfg.rope_theta, sin_fn=sin_fn)
    k = apply_rope(k, positions, cfg.rope_theta, sin_fn=sin_fn)
    out = mha(q, k, v, causal=True, q_offset=pos_offset,
              exp_fn=site_act(cfg, lut_tables, sites.ATTN_EXP, layer))
    out = torch.matmul(out.reshape(b, t, cfg.q_dim), p["wo"])
    return out, (k, v)


def _decode_attn(p, x, cfg, k_cache, v_cache, pos: int, *, lut_tables=None,
                 layer: int | None = None):
    """Single-token attention against one layer's cache ``(B, Tmax, KV,
    Dh)``.  The new entry is written into the cache in place (the
    reference returns an updated copy; in place saves the copy)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    pos_arr = torch.full((1,), pos, device=x.device)
    sin_fn = site_act(cfg, lut_tables, sites.ROPE, layer)
    q = apply_rope(q, pos_arr, cfg.rope_theta, sin_fn=sin_fn)
    k = apply_rope(k, pos_arr, cfg.rope_theta, sin_fn=sin_fn)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    out = decode_attend(q, k_cache, v_cache, pos,
                        exp_fn=site_act(cfg, lut_tables, sites.ATTN_EXP,
                                        layer))
    return torch.matmul(out.reshape(b, 1, cfg.q_dim), p["wo"])


# =========================================================================
# decoder-only forward (dense)
# =========================================================================
def _decoder_block(p, x, cfg, lut_tables, *, pos_offset: int = 0,
                   layer: int | None = None):
    rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, layer)
    h, kv = _attn_apply(p, rms_norm(x, p["ln1"], cfg.norm_eps, rs), cfg,
                        pos_offset=pos_offset, lut_tables=lut_tables,
                        layer=layer)
    x = x + h
    hin = rms_norm(x, p["ln2"], cfg.norm_eps, rs)
    x = x + mlp_block(p, hin, cfg, lut_tables, layer=layer)
    return x, kv


def decoder_forward(params: DecoderParams, cfg: ArchConfig,
                    tokens: torch.Tensor, lut_tables=None,
                    collect_kv: bool = False, kv_sink=None):
    """Returns ``(hidden (B, T, d), kvs)``; ``kvs`` is the list of
    per-layer ``(k, v)`` when ``collect_kv``, else ``None``.  ``kv_sink``
    (``fn(layer, k, v)``) receives each layer's K/V instead, so a caller
    can write them into a preallocated cache without keeping the list."""
    x = embed_lookup(params.embed, tokens)
    kvs = [] if collect_kv else None
    for i in range(cfg.n_layers):
        x, (k, v) = _decoder_block(params.layer(i), x, cfg, lut_tables,
                                   layer=i)
        if kv_sink is not None:
            kv_sink(i, k, v)
        elif collect_kv:
            kvs.append((k, v))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, kvs
