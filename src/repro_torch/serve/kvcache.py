"""Decode-state construction (PyTorch port of the reference's
``serve/kvcache.py``: the decoder families' (dense, moe, vlm) bf16 and
int8 KV caches, the ssm family's recurrent state, the hybrid family's
nested recurrent and ring-buffer state, and the encdec family's self and
cross K/V), and the walks over a state's
tensors that a captured step and its checks need."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               kv_dtype: str | None = None) -> dict:
    """Zero-initialized decode state, ``dtype`` bf16 by default as the
    reference's.  Dense and moe: ``{"k", "v"}``, layout ``(L, B, Tmax, KV, Dh)``;
    with ``kv_dtype="int8"`` (the reference's quantized KV cache) ``k`` and
    ``v`` are int8 and ``{"k_scale", "v_scale"}`` ``(L, B, Tmax, KV)``
    float32 hold their per-(position, head) scales.  Ssm (RWKV6):
    ``{"att_x", "ffn_x"}`` ``(L, B, 1, d)`` in ``dtype`` and ``"wkv"``
    ``(L, B, H, N, N)`` in float32.  Hybrid: ``{"groups": {"t{i}": …},
    "tail": {"t{i}": …}}``, per pattern position of the groups a recurrent
    layer's ``{"conv": (G, B, K-1, d_rnn)}`` in ``dtype`` and ``{"lru":
    (G, B, d_rnn)}`` in float32, or an attention layer's ring ``{"k",
    "v"}`` ``(G, B, W, KV, Dh)``; the tail's recurrent layers without the
    leading axis.  Encdec: the self-attention's ``{"k", "v"}`` as dense,
    and the cross-attention's ``{"xk", "xv"}`` ``(L, B, n_frames, KV, Dh)``,
    written once by prefill and only read by decode.  Neither ``max_seq``
    nor ``kv_dtype`` shapes an ssm or hybrid state, and ``kv_dtype`` does
    not change an encdec cache, as in the reference."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"init_cache: kv_dtype {kv_dtype!r} is not 'int8' "
                         f"(other caches take their type from dtype)")
    dev = resolve_device(device)
    L = cfg.n_layers
    if cfg.family == "ssm":
        d, n = cfg.d_model, cfg.rwkv_head_dim
        return {
            "att_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=dev),
            "ffn_x": torch.zeros((L, batch, 1, d), dtype=dtype, device=dev),
            "wkv": torch.zeros((L, batch, d // n, n, n),
                               dtype=torch.float32, device=dev),
        }
    if cfg.family == "hybrid":
        return _hybrid_state(cfg, batch, dtype, dev)
    shape = (L, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    if cfg.family == "encdec":
        cross = (L, batch, cfg.n_frames, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "xk": torch.zeros(cross, dtype=dtype, device=dev),
                "xv": torch.zeros(cross, dtype=dtype, device=dev)}
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"init_cache: unknown family {cfg.family!r}")
    if kv_dtype == "int8":
        cache = {n: torch.zeros(shape, dtype=torch.int8, device=dev)
                 for n in ("k", "v")}
        cache.update({n: torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=dev)
                      for n in ("k_scale", "v_scale")})
        return cache
    return {n: torch.zeros(shape, dtype=dtype, device=dev)
            for n in ("k", "v")}


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int,
                   dtype: torch.dtype = torch.bfloat16, device="meta",
                   kv_dtype: str | None = None) -> dict:
    """:func:`init_cache` without data (the ``meta`` device, or fake
    tensors inside a ``FakeTensorMode``): a dry run's decode state."""
    return init_cache(cfg, batch, max_seq, dtype, device, kv_dtype)


def _hybrid_state(cfg: ArchConfig, batch: int, dtype, dev) -> dict:
    from repro_torch.nn.transformer import block_pattern, hybrid_layout

    n_groups, n_tail = hybrid_layout(cfg)
    drnn = cfg.d_rnn or cfg.d_model
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)

    def rec(lead):
        return {"conv": zeros(lead + (batch, cfg.conv_width - 1, drnn)),
                "lru": zeros(lead + (batch, drnn), torch.float32)}

    ring = (n_groups, batch, cfg.local_window, cfg.n_kv_heads, cfg.d_head)
    groups = {f"t{i}": rec((n_groups,)) if kind == "rec"
              else {"k": zeros(ring), "v": zeros(ring)}
              for i, kind in enumerate(block_pattern(cfg))}
    return {"groups": groups,
            "tail": {f"t{i}": rec(()) for i in range(n_tail)}}


def state_leaves(state: dict, prefix: str = ""):
    """``(dotted name, tensor)`` of every tensor of a decode state, flat or
    nested, in its order."""
    for name, v in state.items():
        if isinstance(v, dict):
            yield from state_leaves(v, f"{prefix}{name}.")
        else:
            yield prefix + name, v


def clone_state(state: dict) -> dict:
    """A copy of a decode state, flat or nested, every tensor cloned."""
    return {name: clone_state(v) if isinstance(v, dict) else v.clone()
            for name, v in state.items()}
