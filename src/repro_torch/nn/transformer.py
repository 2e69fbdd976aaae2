"""Decoder-only model (dense, moe and vlm), RWKV6 (ssm), Griffin /
RecurrentGemma (hybrid) and Whisper (encdec): PyTorch port of the
reference's ``nn/transformer.py`` forwards.

:class:`DecoderParams`, :class:`RWKVParams`, :class:`HybridParams` and
:class:`EncDecParams` hold the parameters under the reference's names and
stacked layouts (``embed``, ``final_norm``, ``lm_head``, ``blocks.{…}``
stacked ``(L, …)``; vlm's ``patch_proj``; hybrid's ``groups.t{i}_{kind}.{…}``
stacked over the groups of the block pattern and ``tail.t{i}_rec.{…}``
with a leading axis of 1; encdec's ``enc_blocks.{…}`` ``(L_enc, …)``,
``dec_blocks.{…}`` with the cross-attention's ``x*`` and ``lnx``, and
``enc_norm``), so a reference parameter tree copies in without renaming
(:func:`repro_torch.bridge.params_from_jax`).  Each forward runs an eager
Python loop over layers with a Python-int layer id.

The losses (:data:`LOSS_FNS`, :func:`loss_fn`) are the reference's
``decoder_loss`` / ``rwkv_loss`` / ``hybrid_loss`` / ``encdec_loss`` for
training: the same forwards, ``remat`` as activation checkpointing of each
layer (each hybrid group) with ``torch.utils.checkpoint``, and the moe
router's auxiliary loss added as the reference adds it.  Serving's
parameters are frozen (``requires_grad`` off); the train state turns
them on (:func:`repro_torch.train.init_train_state`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sites
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from .attention import decode_attend, mha, ring_decode_attend
from .layers import (
    embed_lookup,
    embed_lookup_tp,
    is_gated,
    rms_norm,
    softmax_cross_entropy,
)
from .mlp import mlp_block, project_logits, site_act
from .moe import moe_block
from .rglru import recurrent_block, recurrent_block_step
from .rope import apply_rope
from .sharding import (
    TP_AXIS,
    TPShares,
    copy_to_tp,
    current_mesh,
    current_tp,
    reduce_from_tp,
    use_mesh,
    use_tp,
    vocab_parallel_cross_entropy,
)
from .ssm import rwkv_channel_mix, rwkv_time_mix


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A parameter's shape, init scale and logical axes: per dim ``"tp"``
    (split over the model axis), ``"fsdp"`` (the ZeRO-3 axis of
    training) or ``None``, the reference's annotations
    (:mod:`repro_torch.nn.sharding`); empty means all ``None``."""

    shape: tuple[int, ...]
    scale: float = 1.0
    axes: tuple = ()


# a column-parallel product's weight (output features over the model axis)
# and a row-parallel one's (input features)
_COL = (None, "fsdp", "tp")
_ROW = (None, "tp", "fsdp")


def _rwkv_defs(cfg: ArchConfig) -> dict:
    """RWKV6 block parameters (the reference's ``_rwkv_defs``)."""
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    vec = lambda scale=1.0: ParamDef((L, d), scale)
    mat = lambda m, n: ParamDef((L, m, n), axes=_COL)
    defs = {
        "ln1": vec(0.0), "ln2": vec(0.0), "ln_x": vec(0.0),
        "lora_a": ParamDef((L, d, 32)),
        "decay_a": ParamDef((L, d, 64)),
        "decay_b": ParamDef((L, 64, d), 0.1),
        "decay_base": vec(0.5),
        "bonus": vec(0.5),
        "mu_ffn_k": vec(0.5), "mu_ffn_r": vec(0.5),
        "w_r": mat(d, d), "w_k": mat(d, d), "w_v": mat(d, d),
        "w_g": mat(d, d), "w_o": ParamDef((L, d, d), axes=_ROW),
        "w_ffn_k": mat(d, ff),
        "w_ffn_v": ParamDef((L, ff, d), axes=_ROW),
        "w_ffn_r": mat(d, d),
    }
    for nm in ("r", "k", "v", "w", "g"):
        defs[f"mu_{nm}"] = vec(0.5)
        defs[f"lora_b_{nm}"] = ParamDef((L, 32, d), 0.1)
    return defs


def _attn_defs(cfg: ArchConfig, L: int) -> dict:
    d = cfg.d_model
    defs = {
        "wq": ParamDef((L, d, cfg.q_dim), axes=_COL),
        "wk": ParamDef((L, d, cfg.kv_dim), axes=_COL),
        "wv": ParamDef((L, d, cfg.kv_dim), axes=_COL),
        "wo": ParamDef((L, cfg.q_dim, d), axes=_ROW),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((L, cfg.d_head), 0.0)
        defs["k_norm"] = ParamDef((L, cfg.d_head), 0.0)
    return defs


def _mlp_defs(cfg: ArchConfig, L: int) -> dict:
    ff_in = 2 * cfg.d_ff if is_gated(cfg.activation) else cfg.d_ff
    return {"w_in": ParamDef((L, cfg.d_model, ff_in), axes=_COL),
            "w_out": ParamDef((L, cfg.d_ff, cfg.d_model), axes=_ROW)}


def _rec_defs(cfg: ArchConfig, L: int) -> dict:
    """A recurrent block's parameters (the reference's ``_rec_defs``)."""
    d, drnn = cfg.d_model, cfg.d_rnn or cfg.d_model
    return {
        "w_in": ParamDef((L, d, drnn), axes=_COL),
        "w_gate": ParamDef((L, d, drnn), axes=_COL),
        "w_out": ParamDef((L, drnn, d), axes=_ROW),
        "conv_w": ParamDef((L, cfg.conv_width, drnn), axes=(None, None, "tp")),
        "w_a": ParamDef((L, drnn, drnn), axes=_COL),
        "w_x": ParamDef((L, drnn, drnn), axes=_COL),
        "lam": ParamDef((L, drnn), 0.5, axes=(None, "tp")),
    }


def block_pattern(cfg: ArchConfig) -> tuple[str, ...]:
    """The hybrid family's repeating unit of temporal blocks."""
    return cfg.block_pattern or ("rec", "rec", "attn")


def hybrid_layout(cfg: ArchConfig) -> tuple[int, int]:
    """``(n_groups, n_tail)``: whole repeats of the block pattern, then the
    recurrent layers left over (recurrentgemma-9b: 12 groups of (rec,
    rec, attn) and a tail of 2)."""
    unit = len(block_pattern(cfg))
    return cfg.n_layers // unit, cfg.n_layers % unit


def _hybrid_defs(cfg: ArchConfig) -> dict:
    """The reference's hybrid layout: per pattern position ``i`` the
    temporal block ``t{i}_{kind}``, its norm ``t{i}_ln``, the MLP
    ``m{i}`` and its norm ``m{i}_ln``, stacked over the groups; the tail
    the same for its recurrent layers with a leading axis of 1."""
    n_groups, n_tail = hybrid_layout(cfg)
    d = cfg.d_model
    groups = {}
    for i, kind in enumerate(block_pattern(cfg)):
        groups[f"t{i}_{kind}"] = (_rec_defs(cfg, n_groups) if kind == "rec"
                                  else _attn_defs(cfg, n_groups))
        groups[f"t{i}_ln"] = ParamDef((n_groups, d), 0.0)
        groups[f"m{i}"] = _mlp_defs(cfg, n_groups)
        groups[f"m{i}_ln"] = ParamDef((n_groups, d), 0.0)
    defs = {"groups": groups}
    if n_tail:
        tail = {}
        for i in range(n_tail):
            tail[f"t{i}_rec"] = _rec_defs(cfg, 1)
            tail[f"t{i}_ln"] = ParamDef((1, d), 0.0)
            tail[f"m{i}"] = _mlp_defs(cfg, 1)
            tail[f"m{i}_ln"] = ParamDef((1, d), 0.0)
        defs["tail"] = tail
    return defs


def _encdec_defs(cfg: ArchConfig) -> dict:
    """The reference's encdec layout: the encoder's attention, MLP and two
    norms stacked over its layers; the decoder's the same plus the
    cross-attention (``xwq`` / ``xwk`` / ``xwv`` / ``xwo``) and its norm
    ``lnx``; the encoder's final norm ``enc_norm``."""
    Le, L, d = cfg.n_encoder_layers, cfg.n_layers, cfg.d_model
    enc = dict(_attn_defs(cfg, Le), **_mlp_defs(cfg, Le),
               ln1=ParamDef((Le, d), 0.0), ln2=ParamDef((Le, d), 0.0))
    dec = dict(_attn_defs(cfg, L), **_mlp_defs(cfg, L))
    dec.update({"x" + k: v for k, v in _attn_defs(cfg, L).items()})
    dec.update(ln1=ParamDef((L, d), 0.0), lnx=ParamDef((L, d), 0.0),
               ln2=ParamDef((L, d), 0.0))
    return {"enc_blocks": enc, "dec_blocks": dec,
            "enc_norm": ParamDef((d,), 0.0)}


def param_defs(cfg: ArchConfig) -> dict:
    """Names and shapes of the model's parameters (the reference's
    ``param_defs``)."""
    L, d = cfg.n_layers, cfg.d_model
    head = {
        "embed": ParamDef((cfg.vocab_size, d), axes=("tp", "fsdp")),
        "final_norm": ParamDef((d,), 0.0),
        "lm_head": ParamDef((d, cfg.vocab_size), axes=("fsdp", "tp")),
    }
    if cfg.family == "ssm":
        return dict(head, blocks=_rwkv_defs(cfg))
    if cfg.family == "hybrid":
        return dict(head, **_hybrid_defs(cfg))
    if cfg.family == "encdec":
        return dict(head, **_encdec_defs(cfg))
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"param_defs: unknown family {cfg.family!r}")
    blocks = _attn_defs(cfg, L)
    blocks["ln1"] = ParamDef((L, d), 0.0)
    blocks["ln2"] = ParamDef((L, d), 0.0)
    if cfg.moe:
        m = cfg.moe
        blocks["router"] = ParamDef((L, d, m.n_experts))
        blocks["moe_w_in"] = ParamDef((L, m.n_experts, d, 2 * m.d_expert),
                                      axes=(None, "tp", "fsdp", None))
        blocks["moe_w_out"] = ParamDef((L, m.n_experts, m.d_expert, d),
                                       axes=(None, "tp", None, "fsdp"))
        if m.n_shared:
            blocks["sh_w_in"] = ParamDef((L, d, 2 * m.d_expert * m.n_shared),
                                         axes=_COL)
            blocks["sh_w_out"] = ParamDef((L, m.d_expert * m.n_shared, d),
                                          axes=_ROW)
    else:
        blocks.update(_mlp_defs(cfg, L))
    defs = dict(head, blocks=blocks)
    if cfg.family == "vlm":
        defs["patch_proj"] = ParamDef((d, d))
    return defs


def _flat_defs(defs: dict, prefix: str = "") -> list:
    """``[(dotted name, ParamDef, stacked)]`` of a :func:`param_defs` tree,
    in its order; ``stacked``: the leaf lies in a tree (``blocks``,
    ``groups``, ``tail``) and has a leading layer axis."""
    out = []
    for name, d in defs.items():
        if isinstance(d, dict):
            out += [(n, dd, True)
                    for n, dd, _ in _flat_defs(d, f"{prefix}{name}.")]
        else:
            out.append((prefix + name, d, bool(prefix)))
    return out


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _tree(defs: dict, dtype, device, leaves=None, prefix="") -> nn.Module:
    """A parameter for each leaf of ``defs``, a child module for each
    sub-tree: an ``nn.ParameterDict`` where every entry is a leaf.  With
    ``leaves`` (dotted name -> tensor) each parameter wraps its tensor
    instead of a new one."""
    def leaf(k, d):
        if leaves is None:
            return _param(d.shape, dtype, device)
        return nn.Parameter(leaves[prefix + k], requires_grad=False)

    if not any(isinstance(d, dict) for d in defs.values()):
        return nn.ParameterDict({k: leaf(k, d) for k, d in defs.items()})
    mod = nn.Module()
    for k, d in defs.items():
        setattr(mod, k, _tree(d, dtype, device, leaves, f"{prefix}{k}.")
                if isinstance(d, dict) else leaf(k, d))
    return mod


def _index(tree: nn.Module, i: int) -> dict:
    """Entry ``i`` of every stack in ``tree``, as views, under its names."""
    out = {n: p[i] for n, p in tree.named_parameters(recurse=False)}
    out.update({n: _index(c, i) for n, c in tree.named_children()})
    return out


def _unbind(tree: nn.Module) -> list[dict]:
    """Every entry of the stacks in ``tree``, as :func:`_index` gives them,
    from one ``unbind`` per stack.  A stack's gradient then comes back as
    one stacked tensor (``unbind``'s backward), not as one zero-padded
    full-size tensor per layer (``select``'s, summed into the stack)."""
    cols = {n: p.unbind(0) for n, p in tree.named_parameters(recurse=False)}
    cols.update({n: _unbind(c) for n, c in tree.named_children()})
    n = len(next(iter(cols.values())))
    return [{k: v[i] for k, v in cols.items()} for i in range(n)]


class _StackedParams(nn.Module):
    """Parameters of :func:`param_defs` (frozen for serving): the head
    tensors as attributes, each tree of stacks (``blocks``, ``groups``,
    ``tail``) as a module of the same name.  ``leaves`` (dotted name ->
    tensor) wraps given tensors instead of allocating: a rank's shares or
    the weights it gathered (:mod:`repro_torch.serve.sharded`)."""

    _views = None   # {tree: [entry dicts]} inside unstacked()

    def __init__(self, cfg: ArchConfig, device=None, leaves=None):
        super().__init__()
        dev = resolve_device(device)
        dt = torch_dtype(cfg.dtype)
        for name, d in param_defs(cfg).items():
            if isinstance(d, dict):
                setattr(self, name, _tree(d, dt, dev, leaves, f"{name}."))
            elif leaves is None:
                setattr(self, name, _param(d.shape, dt, dev))
            else:
                setattr(self, name,
                        nn.Parameter(leaves[name], requires_grad=False))

    def _entry(self, tree: str, i: int) -> dict:
        if self._views is not None:
            return self._views[tree][i]
        return _index(getattr(self, tree), i)

    @contextlib.contextmanager
    def unstacked(self):
        """Within the block, the per-layer accessors hand out views from one
        ``unbind`` per stack (:func:`_unbind`): what a loss differentiates
        through.  Outside it (serving), each call indexes the stacks."""
        self._views = {n: _unbind(c) for n, c in self.named_children()}
        try:
            yield self
        finally:
            self._views = None

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as views into the stacks."""
        return self._entry("blocks", i)


class DecoderParams(_StackedParams):
    """Decoder parameters (the dense, moe and vlm families)."""


class RWKVParams(_StackedParams):
    """RWKV6 parameters (the ssm family)."""


class HybridParams(_StackedParams):
    """Griffin / RecurrentGemma parameters (the hybrid family)."""

    def group(self, g: int) -> dict:
        """Group ``g``'s parameters (``t{i}_{kind}``, ``t{i}_ln``, ``m{i}``,
        ``m{i}_ln`` per pattern position), as views into the stacks."""
        return self._entry("groups", g)

    def tail_layer(self, i: int) -> dict:
        """The ``i``-th tail layer's parameters (``rec``, ``ln``, ``m``,
        ``m_ln``), as views."""
        t = self._entry("tail", 0)
        return {"rec": t[f"t{i}_rec"], "ln": t[f"t{i}_ln"],
                "m": t[f"m{i}"], "m_ln": t[f"m{i}_ln"]}


class EncDecParams(_StackedParams):
    """Whisper parameters (the encdec family)."""

    def enc_layer(self, i: int) -> dict:
        """Encoder layer ``i``'s parameters, as views into the stacks."""
        return self._entry("enc_blocks", i)

    def layer(self, i: int) -> dict:
        """Decoder layer ``i``'s parameters (self-attention, cross-attention
        ``x*`` and ``lnx``, MLP), as views into the stacks."""
        return self._entry("dec_blocks", i)


def params_class(cfg: ArchConfig) -> type:
    return {"ssm": RWKVParams, "hybrid": HybridParams,
            "encdec": EncDecParams}.get(cfg.family, DecoderParams)


def init_params(cfg: ArchConfig, seed: int = 0, device=None
                ) -> _StackedParams:
    """Random parameters from ``seed`` with the reference's distributions:
    zeros for scale-0 vectors, ``N(0, 0.02 * scale)`` for vectors and
    narrow matrices, and a normal truncated at +-2 scaled by
    ``scale / sqrt(fan_in)`` otherwise (the distribution is chosen by the
    whole stack's shape, as the reference chooses it).  A ``(L, …)``
    stack is drawn one layer at a time, so the float32 draw never holds
    more than one layer (deepseek-moe-16b's ``moe_w_in`` whole would take
    41 GB).  The bits differ from the reference's (another generator);
    :mod:`repro_torch.bridge` copies reference parameters in exactly."""
    params = params_class(cfg)(cfg, device)
    named = dict(params.named_parameters())
    with torch.no_grad():
        for name, i, v in draw_params(cfg, seed, params.embed.device):
            t = named[name]
            part = t if i is None else t[i]
            if v is None:
                part.zero_()
            else:
                part.copy_(v)
    return params


def abstract_params(cfg: ArchConfig, device="meta", placements=None
                    ) -> _StackedParams:
    """:func:`init_params`' parameters without data (a dry run's): on the
    ``meta`` device, or fake tensors on any device inside a
    ``FakeTensorMode``; nothing drawn, nothing allocated.  With
    ``placements`` (``{dotted name: Placement}``) each leaf is a rank's
    share."""
    if placements is None:
        return params_class(cfg)(cfg, device)
    dt = torch_dtype(cfg.dtype)
    return params_class(cfg)(cfg, device, leaves={
        name: torch.empty(placements[name].local_shape(d.shape), dtype=dt,
                          device=device)
        for name, d, _ in _flat_defs(param_defs(cfg))})


def draw_params(cfg: ArchConfig, seed: int, device):
    """:func:`init_params`' draws in order, one leaf or one layer of a
    stack at a time: ``(dotted name, layer index or None, float32 values
    or None for a zero leaf)``.  The next draw is allocated only after the
    caller has taken the last, so a caller that keeps a share of each
    (:func:`repro_torch.serve.sharded.init_params_sharded`) never holds a
    whole stack."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, d, stacked in _flat_defs(param_defs(cfg)):
        if d.scale == 0.0:
            yield name, None, None
            continue
        narrow = len(d.shape) == 1 or (d.shape[-1] <= 64
                                       and len(d.shape) == 2)
        for i in (range(d.shape[0]) if stacked else (None,)):
            shape = d.shape[1:] if stacked else d.shape
            v = torch.empty(shape, dtype=torch.float32, device=device)
            if narrow:
                v.normal_(0.0, 0.02 * d.scale, generator=gen)
            else:
                nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=gen)
                v.mul_(d.scale / math.sqrt(d.shape[-2]))
            yield name, i, v
            del v   # before the next layer's draw is allocated


# =========================================================================
# attention sub-block
# =========================================================================
def _qkv(p, x, cfg):
    """Queries, keys and values ``(B, T, heads, Dh)``: every head, or in
    a partitioned train step the rank's (the heads follow the weights'
    columns)."""
    b, t, _ = x.shape
    q = torch.matmul(x, p["wq"]).reshape(b, t, -1, cfg.d_head)
    k = torch.matmul(x, p["wk"]).reshape(b, t, -1, cfg.d_head)
    v = torch.matmul(x, p["wv"]).reshape(b, t, -1, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_apply(p, x, cfg, *, causal: bool = True, window: int | None = None,
                pos_offset: int = 0, rope: bool = True, lut_tables=None,
                layer: int | None = None, chunk_q: int = 512,
                tp_leaf: str = "blocks.wq"):
    """Self-attention over a segment at positions ``pos_offset ..``,
    causal and, with ``window``, local; queries in chunks of ``chunk_q``.
    Returns (out, (k, v)).  In a partitioned train step that splits the
    leaf ``p["wq"]`` is (``tp_leaf``, its dotted name) the rank's heads
    only (:func:`_tp_heads`), ``wo`` row-parallel with its partial sums
    reduced over the model axis."""
    b, t, _ = x.shape
    tp = current_tp()
    split = tp is not None and tp.splits(tp_leaf)
    kv_index = None
    if split:
        p, x, kv_index = _tp_heads(p, x, cfg, tp, tp_leaf)
    q, k, v = _qkv(p, x, cfg)
    if kv_index is not None:
        k, v = k.index_select(2, kv_index), v.index_select(2, kv_index)
    if rope:
        positions = torch.arange(t, device=x.device) + pos_offset
        sin_fn = site_act(cfg, lut_tables, sites.ROPE, layer)
        q = apply_rope(q, positions, cfg.rope_theta, sin_fn=sin_fn)
        k = apply_rope(k, positions, cfg.rope_theta, sin_fn=sin_fn)
    out = mha(q, k, v, causal=causal, window=window, q_offset=pos_offset,
              chunk_q=chunk_q,
              exp_fn=site_act(cfg, lut_tables, sites.ATTN_EXP, layer))
    out = torch.matmul(out.reshape(b, t, -1), p["wo"])
    if split:
        out = reduce_from_tp(out)
    return out, (k, v)


def _tp_heads(p, x, cfg, tp: TPShares, tp_leaf: str = "blocks.wq"):
    """A partitioned step's attention inputs on rank ``i`` of the model
    axis: ``(p, x, kv_index)``.  ``wq`` / ``wo`` hold its ``n_heads / tp``
    contiguous query heads (the reference's placement), and ``wk`` / ``wv``
    its ``n_kv_heads / tp`` KV heads where tp divides them, so query head
    ``h`` keeps KV head ``h // (n_heads / n_kv_heads)`` on the same rank.
    Where tp does not divide the KV heads, ``wk`` / ``wv`` stay whole (the
    reference's divisibility fallback) and the rank takes the columns of
    the KV heads its query heads read; ``kv_index`` maps each of its query
    heads to one of them where the grouped layout cannot (else ``None``).
    ``x`` and every replicated weight used here enter through
    :func:`~repro_torch.nn.sharding.copy_to_tp`, whose backward sums the
    ranks' partial gradients.  ``tp_leaf``: the dotted name of ``wq``
    (``blocks.wq``, ``groups.t2_attn.wq``, ``dec_blocks.xwq``, ...), whose
    ``wk`` beside it is asked for."""
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = copy_to_tp(p[name])
    kv_index = None
    if not tp.splits(tp_leaf[:-len("wq")] + "wk"):
        hl, g = cfg.n_heads // tp.size, cfg.n_heads // cfg.n_kv_heads
        first = tp.index * hl
        lo, hi = first // g, (first + hl - 1) // g
        cols = slice(lo * cfg.d_head, (hi + 1) * cfg.d_head)
        p["wk"] = copy_to_tp(p["wk"])[:, cols]
        p["wv"] = copy_to_tp(p["wv"])[:, cols]
        heads = [(first + a) // g - lo for a in range(hl)]
        n_kv = hi - lo + 1
        if hl % n_kv or heads != [a // (hl // n_kv) for a in range(hl)]:
            kv_index = torch.tensor(heads, device=x.device)
    return p, copy_to_tp(x), kv_index


# the families the partitioned train step covers: all of them
TP_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


def tp_shares(cfg: ArchConfig, placements: dict, mesh) -> TPShares:
    """The leaves a partitioned train step on ``mesh`` keeps as the rank's
    share over the model axis through the compute (``placements``: the
    parameters' at rest, :func:`repro_torch.train.train_param_shardings`),
    for the families of :data:`TP_FAMILIES` (another raises, naming it).
    A leaf its placement leaves whole on the model axis stays whole, as
    does each group below where tp does not divide its heads or columns
    (the reference's divisibility fallback); norms, routers, vlm's
    ``patch_proj`` and RWKV6's decay LoRA, ``bonus``, ``ln_x`` and
    ``mu_*`` vectors are never split.  Each block's leaves carry its
    tree's prefix: ``blocks.`` (dense, moe, vlm, ssm), ``groups.t{i}_rec.``
    / ``groups.t{i}_attn.`` / ``groups.m{i}.`` and ``tail.t{i}_rec.`` /
    ``tail.m{i}.`` (hybrid), ``enc_blocks.`` and ``dec_blocks.`` (encdec,
    the cross-attention's ``dec_blocks.x*``).

    * ``embed`` / ``lm_head``: the vocabulary (every family; whisper-small's
      odd 51865 stays whole);
    * attention (dense, moe, vlm; the hybrid's local attention; the
      encoder's, the decoder's and the cross-attention): ``wq`` / ``wo`` by
      query heads, ``wk`` / ``wv`` by KV heads;
    * the MLP (dense, vlm, hybrid, encdec): ``w_in`` / ``w_out`` where tp
      divides ``d_ff``; moe's shared experts ``sh_w_in`` / ``sh_w_out``
      where it divides ``d_expert * n_shared`` (a gated ``w_in`` in
      ``gate_up``).  The routed expert stacks keep exact mode's shares over
      the model axis and are not named here;
    * the recurrent block (hybrid): ``w_in`` / ``w_gate`` / ``w_a`` /
      ``w_x`` by columns, ``conv_w`` / ``lam`` by channels and ``w_out``
      by rows, where tp divides ``d_rnn``;
    * RWKV6 (ssm): ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` by columns and
      ``w_o`` by rows, in whole heads, where tp divides ``d /
      rwkv_head_dim``; ``w_ffn_k`` by columns and ``w_ffn_v`` by rows
      where it divides ``d_ff``; ``w_ffn_r`` by columns."""
    if cfg.family not in TP_FAMILIES:
        raise ValueError(f"tp_shares: no partitioned train step for the "
                         f"family {cfg.family!r}")
    tp = mesh.shape.get(TP_AXIS, 1)
    on = lambda *ns: all(
        not placements[n].only((TP_AXIS,)).replicated for n in ns)
    pair = lambda *ns: set(ns) if on(*ns) else set()
    split = {n for n in ("embed", "lm_head") if on(n)}
    if cfg.family == "ssm":
        if (cfg.d_model // cfg.rwkv_head_dim) % tp == 0:
            split |= pair(*(f"blocks.{w}" for w in (
                "w_r", "w_k", "w_v", "w_g", "w_o")))
        if cfg.d_ff % tp == 0:
            split |= pair("blocks.w_ffn_k", "blocks.w_ffn_v")
        split |= pair("blocks.w_ffn_r")
        return TPShares(mesh, frozenset(split))

    mlps = set()          # the split w_in / sh_w_in: gated, in gate_up

    def attn(pre):
        if cfg.n_heads % tp == 0 and on(pre + "wq", pre + "wo"):
            split.update({pre + "wq", pre + "wo"})
            if cfg.n_kv_heads % tp == 0:
                split.update(pair(pre + "wk", pre + "wv"))

    def mlp(pre, width=cfg.d_ff):
        if width % tp == 0 and on(pre + "w_in", pre + "w_out"):
            split.update({pre + "w_in", pre + "w_out"})
            mlps.add(pre + "w_in")

    def rec(pre):
        if (cfg.d_rnn or cfg.d_model) % tp == 0:
            split.update(pair(*(pre + w for w in (
                "w_in", "w_gate", "w_out", "conv_w", "w_a", "w_x", "lam"))))

    if cfg.family == "hybrid":
        n_groups, n_tail = hybrid_layout(cfg)
        for i, kind in enumerate(block_pattern(cfg) if n_groups else ()):
            (rec if kind == "rec" else attn)(f"groups.t{i}_{kind}.")
            mlp(f"groups.m{i}.")
        for i in range(n_tail):
            rec(f"tail.t{i}_rec.")
            mlp(f"tail.m{i}.")
    elif cfg.family == "encdec":
        for pre in ("enc_blocks.", "dec_blocks.", "dec_blocks.x"):
            attn(pre)
        for pre in ("enc_blocks.", "dec_blocks."):
            mlp(pre)
    else:
        attn("blocks.")
        if not cfg.moe:
            mlp("blocks.")
        elif cfg.moe.n_shared:
            mlp("blocks.sh_", cfg.moe.d_expert * cfg.moe.n_shared)
    gate_up = mlps if is_gated(cfg.activation) else set()
    return TPShares(mesh, frozenset(split), frozenset(gate_up))


def _quantize_kv(x: torch.Tensor):
    """(B, 1, KV, Dh) -> (int8 values, (B, 1, KV) float32 scales), as the
    reference's ``_quantize_kv``: a symmetric per-(position, head) scale,
    ``round`` half to even on both sides, and a true division."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _position_index(pos, device) -> torch.Tensor:
    """``pos`` (a Python int or a 0-d integer tensor) as a 1-element int64
    tensor on ``device``, without a host read: what RoPE and the cache
    write take, so that a step captured in a CUDA graph reads the position
    from a buffer instead of baking it in."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), pos, dtype=torch.long, device=device)


def _decode_attn(p, x, cfg, k_cache, v_cache, pos, *, window=None,
                 scales=None, lut_tables=None, layer: int | None = None):
    """Single-token attention against one layer's cache ``(B, Tmax, KV,
    Dh)`` at position ``pos`` (a Python int or a 0-d integer tensor on the
    cache's device; both give the same bits).  The new entry is written
    into the cache in place (the reference returns an updated copy; in
    place saves the copy).  ``scales``: the layer's ``(k_scale, v_scale)``
    ``(B, Tmax, KV)`` of an int8 cache, quantized at the write and
    dequantized at the read.  ``window``: the cache is a ring of ``W``
    slots (the hybrid family's local attention): the entry goes to slot
    ``pos % W``, and the position each slot holds, ``pos - ((pos - s) %
    W)``, is computed on the device, as is the slot."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    pos_arr = _position_index(pos, x.device)
    sin_fn = site_act(cfg, lut_tables, sites.ROPE, layer)
    q = apply_rope(q, pos_arr, cfg.rope_theta, sin_fn=sin_fn)
    k = apply_rope(k, pos_arr, cfg.rope_theta, sin_fn=sin_fn)
    exp_fn = site_act(cfg, lut_tables, sites.ATTN_EXP, layer)
    if scales is not None:
        k_scale, v_scale = scales
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        k_cache.index_copy_(1, pos_arr, kq)
        v_cache.index_copy_(1, pos_arr, vq)
        k_scale.index_copy_(1, pos_arr, ks.to(k_scale.dtype))
        v_scale.index_copy_(1, pos_arr, vs.to(v_scale.dtype))
        out = decode_attend(q, k_cache, v_cache, pos, exp_fn=exp_fn,
                            k_scale=k_scale, v_scale=v_scale)
    elif window is not None:
        w = k_cache.shape[1]
        slot = pos_arr % w
        k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
        v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
        slots = torch.arange(w, device=x.device)
        stored = pos_arr - ((pos_arr - slots) % w)
        out = ring_decode_attend(q, k_cache, v_cache, stored, pos_arr,
                                 window, exp_fn=exp_fn)
    else:
        k_cache.index_copy_(1, pos_arr, k.to(k_cache.dtype))
        v_cache.index_copy_(1, pos_arr, v.to(v_cache.dtype))
        out = decode_attend(q, k_cache, v_cache, pos, exp_fn=exp_fn)
    return torch.matmul(out.reshape(b, 1, cfg.q_dim), p["wo"])


# =========================================================================
# decoder-only forward (dense, moe, vlm)
# =========================================================================
def _decoder_embed(params: DecoderParams, cfg: ArchConfig,
                   tokens: torch.Tensor, patches: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Token embeddings; for vlm with ``patches`` (B, P, d) the projected
    patch embeddings come first (cast to the model dtype before the
    ``patch_proj`` product, as the reference casts them)."""
    x = _embed_tokens(params.embed, tokens)
    if cfg.family == "vlm" and patches is not None:
        pre = torch.matmul(patches.to(x.dtype), params.patch_proj)
        x = torch.cat([pre, x], dim=1)
    return x


def _embed_tokens(embed: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """The token embeddings; in a partitioned train step that splits
    ``embed`` the vocab-parallel lookup of the rank's rows."""
    tp = current_tp()
    if tp is not None and tp.splits("embed"):
        return embed_lookup_tp(embed, tokens, tp.index * embed.shape[0])
    return embed_lookup(embed, tokens)


def _run(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward instead of kept (the reference's ``jax.checkpoint`` of a
    layer body), through ``torch.utils.checkpoint``.  The recompute runs in
    the autograd engine's thread, so it is handed the caller's mesh and tp
    shares (a thread's own, :func:`~repro_torch.nn.sharding.use_mesh`,
    :func:`~repro_torch.nn.sharding.use_tp`)."""
    if remat:
        mesh, tp = current_mesh(), current_tp()
        if mesh is not None:
            body = fn

            def fn(*a):
                with use_mesh(mesh), use_tp(tp):
                    return body(*a)
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def feed_forward_aux(p, x, cfg, lut_tables, layer: int | None = None):
    """A decoder layer's feed-forward part on its normed input: the MLP
    (dense), or the routed experts plus the shared experts' MLP (moe).
    Returns ``(y, aux)``: the moe router's auxiliary loss (float32, 0-d),
    ``None`` for the MLP."""
    if not cfg.moe:
        return mlp_block(p, x, cfg, lut_tables, layer=layer), None
    shared = None
    if cfg.moe.n_shared:
        shared = lambda z: mlp_block(
            {"w_in": p["sh_w_in"], "w_out": p["sh_w_out"]}, z, cfg,
            lut_tables, layer=layer, tp_leaf="blocks.sh_w_in")
    return moe_block({"router": p["router"], "w_in": p["moe_w_in"],
                      "w_out": p["moe_w_out"]}, x, cfg, shared_mlp=shared,
                     lut_tables=lut_tables, layer=layer)


def feed_forward(p, x, cfg, lut_tables, layer: int | None = None):
    """:func:`feed_forward_aux` without the auxiliary loss, as serving
    discards it.  Prefill, decode and replay all go through here."""
    return feed_forward_aux(p, x, cfg, lut_tables, layer=layer)[0]


def _decoder_block(p, x, cfg, lut_tables, *, pos_offset: int = 0,
                   layer: int | None = None, chunk_q: int = 512):
    """One decoder layer: ``(x, aux, (k, v))``."""
    rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, layer)
    h, kv = _attn_apply(p, rms_norm(x, p["ln1"], cfg.norm_eps, rs), cfg,
                        pos_offset=pos_offset, lut_tables=lut_tables,
                        layer=layer, chunk_q=chunk_q)
    x = x + h
    hin = rms_norm(x, p["ln2"], cfg.norm_eps, rs)
    y, aux = feed_forward_aux(p, hin, cfg, lut_tables, layer=layer)
    return x + y, aux, kv


def _decoder_run(params: DecoderParams, cfg: ArchConfig, tokens, patches,
                 lut_tables, *, collect_kv: bool = False, kv_sink=None,
                 remat: bool = False, chunk_q: int = 512):
    """:func:`decoder_forward` that also returns the layers' moe auxiliary
    losses (a list, empty without moe; summed by the loss alone, so that
    serving launches nothing for them)."""
    x = _decoder_embed(params, cfg, tokens, patches)
    kvs = [] if collect_kv else None
    auxes = []
    for i in range(cfg.n_layers):
        p = params.layer(i)
        if remat:
            x, a = _run(lambda x, p=p, i=i: _decoder_block(
                p, x, cfg, lut_tables, layer=i, chunk_q=chunk_q)[:2],
                True, x)
        else:
            x, a, (k, v) = _decoder_block(p, x, cfg, lut_tables, layer=i,
                                          chunk_q=chunk_q)
            if kv_sink is not None:
                kv_sink(i, k, v)
            elif collect_kv:
                kvs.append((k, v))
        if a is not None:
            auxes.append(a)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, kvs, auxes


def decoder_forward(params: DecoderParams, cfg: ArchConfig,
                    tokens: torch.Tensor, patches: torch.Tensor | None = None,
                    lut_tables=None, collect_kv: bool = False, kv_sink=None):
    """Returns ``(hidden (B, P + T, d), kvs)`` (``P`` vlm patches, else 0);
    ``kvs`` is the list of per-layer ``(k, v)`` when ``collect_kv``, else
    ``None``.  ``kv_sink`` (``fn(layer, k, v)``) receives each layer's K/V
    instead, so a caller can write them into a preallocated cache without
    keeping the list."""
    x, kvs, _ = _decoder_run(params, cfg, tokens, patches, lut_tables,
                             collect_kv=collect_kv, kv_sink=kv_sink)
    return x, kvs


# =========================================================================
# RWKV6 forward (ssm)
# =========================================================================
def _rwkv_layer(p, x, cfg, st: dict, lut_tables, i: int):
    """One RWKV6 layer from state ``st`` (empty: zeros); returns ``(x,
    (att_x, ffn_x, wkv))``, the layer's segment-final state."""
    rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, i)
    h, (ax, wkv) = rwkv_time_mix(
        p, rms_norm(x, p["ln1"], cfg.norm_eps, rs), cfg,
        x_last=st.get("att_x"), wkv_state=st.get("wkv"))
    x = x + h
    h, fx = rwkv_channel_mix(
        p, rms_norm(x, p["ln2"], cfg.norm_eps, rs), cfg,
        x_last=st.get("ffn_x"), lut_tables=lut_tables, layer=i)
    return x + h, (ax, fx, wkv)


def rwkv_forward(params: RWKVParams, cfg: ArchConfig, tokens: torch.Tensor,
                 states: dict | None = None, lut_tables=None,
                 remat: bool = False):
    """Returns ``(hidden (B, T, d), states)``.

    ``states`` is the per-layer recurrent state ``{"att_x": (L, B, 1, d),
    "ffn_x": (L, B, 1, d), "wkv": (L, B, H, N, N) f32}``
    (:func:`repro_torch.serve.kvcache.init_cache`): the segment starts from
    it and each layer's segment-final state is written back into it in
    place (the reference returns new stacks).  A zero state is the
    reference's fresh prefill, bit for bit; ``None`` runs the segment
    from zeros and keeps no state (calibration capture, training).
    ``remat`` (training, no ``states``) recomputes each layer in the
    backward."""
    if remat and states:
        raise ValueError("rwkv_forward: remat is for training, which keeps "
                         "no state")
    x = _embed_tokens(params.embed, tokens)
    for i in range(cfg.n_layers):
        p = params.layer(i)
        st = {k: v[i] for k, v in states.items()} if states else {}
        if remat:
            x = _run(lambda x, p=p, i=i: _rwkv_layer(
                p, x, cfg, {}, lut_tables, i)[0], True, x)
            continue
        x, (ax, fx, wkv) = _rwkv_layer(p, x, cfg, st, lut_tables, i)
        if st:
            st["att_x"].copy_(ax)
            st["ffn_x"].copy_(fx)
            st["wkv"].copy_(wkv)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, states


# =========================================================================
# Griffin / RecurrentGemma forward (hybrid)
# =========================================================================
def _ring_from_segment(k: torch.Tensor, v: torch.Tensor, window: int):
    """The decode ring buffer from a prefill segment (positions 0 ..
    T-1): slot ``s`` holds the latest position ``p`` with ``p % W == s``,
    zeros where no position has reached it yet."""
    t = k.shape[1]
    slots = torch.arange(window, device=k.device)
    p = (t - 1) - ((t - 1 - slots) % window)
    valid = (p >= 0)[None, :, None, None]
    idx = torch.clamp(p, 0, t - 1)
    return (torch.where(valid, k[:, idx], 0),
            torch.where(valid, v[:, idx], 0))


def _hybrid_temporal(kind: str, p, x, cfg, pos, state, mode: str,
                     pre: str = ""):
    """One temporal block (``rec`` or local ``attn``).  ``decode``: one
    token against ``state``, updated in place; ``prefill``: a fresh
    segment whose final state (the conv window and LRU vector, or the
    ring) is written into ``state``; ``train``: no state.  ``pre``: the
    block's leaf prefix (``groups.t0_rec.``, ``tail.t1_rec.``, ...), the
    names a partitioned train step's shares go by."""
    if kind == "rec":
        if mode == "decode":
            out, _ = recurrent_block_step(p, x, cfg, state)
            return out
        out, st = recurrent_block(p, x, cfg, tp_leaf=pre + "w_in")
        if state is not None:
            state["conv"].copy_(st["conv"])
            state["lru"].copy_(st["lru"])
        return out
    if mode == "decode":
        return _decode_attn(p, x, cfg, state["k"], state["v"], pos,
                            window=cfg.local_window)
    out, (k, v) = _attn_apply(p, x, cfg, causal=True,
                              window=cfg.local_window, pos_offset=pos,
                              tp_leaf=pre + "wq")
    if state is not None:
        kr, vr = _ring_from_segment(k, v, cfg.local_window)
        state["k"].copy_(kr)
        state["v"].copy_(vr)
    return out


def _hybrid_layer(kind, p_t, ln, p_m, m_ln, x, cfg, pos, state, mode,
                  lut_tables, layer: int, names: tuple[str, str] = ("", "")):
    """One layer; ``names``: the leaf prefixes of its temporal block and
    its MLP (``groups.t{i}_{kind}.``, ``groups.m{i}.``; the tail's
    ``tail.t{i}_rec.``, ``tail.m{i}.``)."""
    rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, layer)
    x = x + _hybrid_temporal(kind, p_t, rms_norm(x, ln, cfg.norm_eps, rs),
                             cfg, pos, state, mode, names[0])
    return x + mlp_block(p_m, rms_norm(x, m_ln, cfg.norm_eps, rs), cfg,
                         lut_tables, layer=layer, tp_leaf=names[1] + "w_in")


def hybrid_forward(params: HybridParams, cfg: ArchConfig,
                   tokens: torch.Tensor, states: dict | None = None,
                   pos=0, mode: str | None = None, lut_tables=None,
                   remat: bool = False):
    """Returns ``(hidden (B, T, d), states)``.

    ``states`` is the nested decode state of
    :func:`repro_torch.serve.kvcache.init_cache` (``groups.t{i}`` stacked
    over the groups, ``tail.t{i}``).  ``mode``: ``decode`` (the default
    when ``states`` is given) runs ``tokens`` (B, 1) at position ``pos``
    against it and updates it in place; ``prefill`` runs a fresh segment
    from position 0, as the reference's prefill, and writes each layer's
    final state into it; ``train`` (the default without ``states``; what
    calibration capture runs) keeps none.  Layer ids are the reference's:
    ``group * len(pattern) + i`` in the groups, then the tail's.
    ``remat`` (``train`` mode) recomputes each group in the backward, as
    the reference checkpoints its group scan's body (the tail is not)."""
    mode = mode or ("decode" if states is not None else "train")
    if remat and mode != "train":
        raise ValueError(f"hybrid_forward: remat is for training, not "
                         f"{mode!r}")
    pattern = block_pattern(cfg)
    n_groups, n_tail = hybrid_layout(cfg)
    x = _embed_tokens(params.embed, tokens)

    def group(x, p, g, gstates):
        for i, kind in enumerate(pattern):
            st = None
            if gstates is not None:
                st = {k: v[g] for k, v in gstates[f"t{i}"].items()}
            x = _hybrid_layer(kind, p[f"t{i}_{kind}"], p[f"t{i}_ln"],
                              p[f"m{i}"], p[f"m{i}_ln"], x, cfg, pos, st,
                              mode, lut_tables, g * len(pattern) + i,
                              (f"groups.t{i}_{kind}.", f"groups.m{i}."))
        return x

    for g in range(n_groups):
        p = params.group(g)
        if remat:
            x = _run(lambda x, p=p, g=g: group(x, p, g, None), True, x)
        else:
            x = group(x, p, g, None if states is None else states["groups"])
    tail_base = n_groups * len(pattern)
    for i in range(n_tail):
        p = params.tail_layer(i)
        st = states["tail"][f"t{i}"] if states is not None else None
        x = _hybrid_layer("rec", p["rec"], p["ln"], p["m"], p["m_ln"], x,
                          cfg, pos, st, mode, lut_tables, tail_base + i,
                          (f"tail.t{i}_rec.", f"tail.m{i}."))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, states


# =========================================================================
# Whisper forward (encdec)
# =========================================================================
def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """The encoder's (n, d) float32 position table, the reference's
    formula: ``sin`` then ``cos`` of ``pos / 10000 ** (2 i / d)``."""
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _encoder_layer(p, x, cfg):
    h, _ = _attn_apply(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                       causal=False, rope=False, tp_leaf="enc_blocks.wq")
    x = x + h
    return x + mlp_block(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                         tp_leaf="enc_blocks.w_in")


def encoder_forward(params: EncDecParams, cfg: ArchConfig,
                    frames: torch.Tensor, remat: bool = False
                    ) -> torch.Tensor:
    """frames (B, n_frames, d): the stubbed audio frontend's embeddings
    (cast to the model dtype, as the reference casts them).  Returns the
    encoder output (B, n_frames, d).  Bidirectional attention without rope;
    the encoder serves no LUT tables (one pass a request, exact), but
    under an active capture its ``mlp`` (and, in scope, ``attn_exp``)
    sites stream into histograms with no layer, as the reference's do.
    ``remat`` recomputes each layer in the backward."""
    x = frames.to(torch_dtype(cfg.dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    for i in range(cfg.n_encoder_layers):
        x = _run(functools.partial(_encoder_layer, params.enc_layer(i),
                                   cfg=cfg), remat, x)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def cross_kv(p, enc: torch.Tensor, cfg: ArchConfig):
    """A decoder layer's cross-attention K and V (B, S, KV, Dh) from the
    encoder output (a partitioned step's rank: its KV heads)."""
    b, s, _ = enc.shape
    ek = torch.matmul(enc, p["xwk"]).reshape(b, s, -1, cfg.d_head)
    ev = torch.matmul(enc, p["xwv"]).reshape(b, s, -1, cfg.d_head)
    return ek, ev


def cross_attend(p, x, cfg: ArchConfig, ek, ev, lut_tables=None,
                 layer: int | None = None) -> torch.Tensor:
    """Cross-attention of the normed decoder stream ``x`` (B, T, d) over
    the encoder's K / V: every query sees every frame (a partitioned
    step's rank: its query heads, ``xwo``'s partial sums)."""
    b, t, _ = x.shape
    q = torch.matmul(x, p["xwq"]).reshape(b, t, -1, cfg.d_head)
    h = mha(q, ek, ev, causal=False,
            exp_fn=site_act(cfg, lut_tables, sites.ATTN_EXP, layer))
    return torch.matmul(h.reshape(b, t, -1), p["xwo"])


def _cross_block(p, x, enc_out, cfg, lut_tables, i: int):
    """The cross-attention of the normed stream ``x``: ``(out, (ek,
    ev))``.  In a partitioned train step that splits ``dec_blocks.xwq``
    the rank's heads (:func:`_tp_heads` on ``xwq`` / ``xwk`` / ``xwv`` /
    ``xwo``), the whole encoder output through
    :func:`~repro_torch.nn.sharding.copy_to_tp` (its gradient summed over
    the model axis), ``xwo`` row-parallel."""
    tp = current_tp()
    split = tp is not None and tp.splits("dec_blocks.xwq")
    kv_index = None
    if split:
        heads, x, kv_index = _tp_heads(
            {k: p["x" + k] for k in ("wq", "wk", "wv", "wo")}, x, cfg, tp,
            "dec_blocks.xwq")
        p = {"x" + k: v for k, v in heads.items()}
        enc_out = copy_to_tp(enc_out)
    ek, ev = cross_kv(p, enc_out, cfg)
    if kv_index is not None:
        ek, ev = ek.index_select(2, kv_index), ev.index_select(2, kv_index)
    out = cross_attend(p, x, cfg, ek, ev, lut_tables, layer=i)
    return (reduce_from_tp(out) if split else out), (ek, ev)


def _encdec_layer(p, x, enc_out, cfg, lut_tables, i: int):
    """One decoder layer: ``(x, (k, v, ek, ev))``."""
    rs = site_act(cfg, lut_tables, sites.NORM_RSQRT, i)
    h, (k, v) = _attn_apply(p, rms_norm(x, p["ln1"], cfg.norm_eps, rs),
                            cfg, causal=True, rope=True,
                            lut_tables=lut_tables, layer=i,
                            tp_leaf="dec_blocks.wq")
    x = x + h
    h, (ek, ev) = _cross_block(p, rms_norm(x, p["lnx"], cfg.norm_eps, rs),
                               enc_out, cfg, lut_tables, i)
    x = x + h
    x = x + mlp_block(p, rms_norm(x, p["ln2"], cfg.norm_eps, rs), cfg,
                      lut_tables, layer=i, tp_leaf="dec_blocks.w_in")
    return x, (k, v, ek, ev)


def encdec_forward(params: EncDecParams, cfg: ArchConfig,
                   tokens: torch.Tensor, enc_out: torch.Tensor,
                   lut_tables=None, kv_sink=None, remat: bool = False):
    """The decoder over ``tokens`` (B, T) against ``enc_out``: causal
    self-attention with rope, cross-attention, MLP.  Returns the hidden
    states (B, T, d).  ``kv_sink`` (``fn(layer, k, v, ek, ev)``)
    receives each layer's self K/V and cross K/V (projected once a layer,
    used here and handed on), so prefill can fill its cache.  ``remat``
    (training) recomputes each layer in the backward."""
    x = _embed_tokens(params.embed, tokens)
    for i in range(cfg.n_layers):
        p = params.layer(i)
        if remat:
            x = _run(lambda x, e, p=p, i=i: _encdec_layer(
                p, x, e, cfg, lut_tables, i)[0], True, x, enc_out)
            continue
        x, kvs = _encdec_layer(p, x, enc_out, cfg, lut_tables, i)
        if kv_sink is not None:
            kv_sink(i, *kvs)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


# =========================================================================
# losses (training)
# =========================================================================
def _no_tp_tables(who: str, lut_tables) -> None:
    if current_tp() is not None and lut_tables is not None:
        raise ValueError(f"{who}: the partitioned train step takes no LUT "
                         f"tables")


def _head_loss(x, lm_head, cfg: ArchConfig, labels, lut_tables):
    """Mean cross-entropy of the logits of ``x``.  In a partitioned train
    step that splits ``lm_head`` the rank's vocab columns give its logits,
    and the loss is
    :func:`~repro_torch.nn.sharding.vocab_parallel_cross_entropy`."""
    tp = current_tp()
    if tp is not None and tp.splits("lm_head"):
        logits = project_logits(copy_to_tp(x), lm_head, cfg)
        return vocab_parallel_cross_entropy(
            logits, labels, tp.index * lm_head.shape[-1])
    return softmax_cross_entropy(project_logits(x, lm_head, cfg, lut_tables),
                                 labels)


def decoder_loss(params: DecoderParams, cfg: ArchConfig, batch: dict,
                 lut_tables=None, remat: bool = False, chunk_q: int = 512):
    """Mean next-token cross-entropy of the decoder; vlm drops the patch
    prefix's positions before the head, moe adds ``router_aux_weight *
    aux / n_layers`` (the layers' summed router auxiliary loss).  In a
    partitioned train step the head is :func:`_head_loss`'s."""
    _no_tp_tables("decoder_loss", lut_tables)
    patches = batch.get("patches")
    with params.unstacked():
        x, _, auxes = _decoder_run(params, cfg, batch["tokens"], patches,
                                   lut_tables, remat=remat, chunk_q=chunk_q)
    if patches is not None:
        x = x[:, patches.shape[1]:]
    loss = _head_loss(x, params.lm_head, cfg, batch["labels"], lut_tables)
    if cfg.moe:
        aux = torch.sum(torch.stack(auxes))
        loss = loss + cfg.moe.router_aux_weight * aux / cfg.n_layers
    return loss


def rwkv_loss(params: RWKVParams, cfg: ArchConfig, batch: dict,
              lut_tables=None, remat: bool = False, **_):
    """Mean cross-entropy of RWKV6 (its WKV through K8 and K8b on the
    card; in a partitioned train step on the rank's heads, the head
    :func:`_head_loss`'s)."""
    _no_tp_tables("rwkv_loss", lut_tables)
    with params.unstacked():
        x, _ = rwkv_forward(params, cfg, batch["tokens"],
                            lut_tables=lut_tables, remat=remat)
    return _head_loss(x, params.lm_head, cfg, batch["labels"], lut_tables)


def hybrid_loss(params: HybridParams, cfg: ArchConfig, batch: dict,
                lut_tables=None, remat: bool = False, **_):
    """Mean cross-entropy of Griffin / RecurrentGemma (in a partitioned
    train step on the rank's channels and heads, the head
    :func:`_head_loss`'s)."""
    _no_tp_tables("hybrid_loss", lut_tables)
    with params.unstacked():
        x, _ = hybrid_forward(params, cfg, batch["tokens"], mode="train",
                              lut_tables=lut_tables, remat=remat)
    return _head_loss(x, params.lm_head, cfg, batch["labels"], lut_tables)


def encdec_loss(params: EncDecParams, cfg: ArchConfig, batch: dict,
                lut_tables=None, remat: bool = False, **_):
    """The encoder over ``batch["frames"]``, then the decoder's mean
    cross-entropy.  The reference's decoder loss passes no tables to the
    decoder layers, only to the head; so does this one.  In a partitioned
    train step the head is :func:`_head_loss`'s: the whole-head route
    where the vocabulary does not split (whisper-small's 51865)."""
    _no_tp_tables("encdec_loss", lut_tables)
    with params.unstacked():
        enc = encoder_forward(params, cfg, batch["frames"], remat=remat)
        x = encdec_forward(params, cfg, batch["tokens"], enc, remat=remat)
    return _head_loss(x, params.lm_head, cfg, batch["labels"], lut_tables)


LOSS_FNS = {
    "dense": decoder_loss,
    "moe": decoder_loss,
    "vlm": decoder_loss,
    "ssm": rwkv_loss,
    "hybrid": hybrid_loss,
    "encdec": encdec_loss,
}


def loss_fn(cfg: ArchConfig):
    """``fn(params, batch=..., lut_tables=None, remat=False,
    chunk_q=512)`` for ``cfg``'s family (``batch`` by keyword, as the
    reference's train step passes it)."""
    return functools.partial(LOSS_FNS[cfg.family], cfg=cfg)
