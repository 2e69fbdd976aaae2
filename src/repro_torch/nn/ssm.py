"""RWKV6 ("Finch") blocks: data-dependent decay linear attention (PyTorch
port of the reference's ``nn/ssm.py``).

Exponent convention (matches :func:`wkv_scan_ref`)::

    y_t = q_t @ S_t + (q_t . (u * k_t)) v_t
    S_{t+1} = w_t[:, None] * S_t + k_t^T v_t        (w_t = exp(log_w_t))

so kv_j reaches y_i (j < i) with decay prod_{s=j+1}^{i-1} w_s.  A prompt
runs the chunkwise-parallel form :func:`wkv_chunked` (kernel K8 on the
card, its plain version on the CPU); a decode step the recurrence
:func:`wkv_decode_step` in plain PyTorch, as in the reference.

In a partitioned train step (:func:`~repro_torch.nn.sharding.use_tp`)
that splits ``w_r`` a rank runs the time mix on its ``H / tp`` heads:
``r`` / ``k`` / ``v`` / ``g`` from its column shares, the decay from its
columns of ``decay_b`` and ``decay_base``, ``bonus`` and ``ln_x`` cut to
its heads, the WKV (K8, K8b) at ``(B, T, H / tp, N)`` and ``w_o``
row-parallel.  The channel mix's ``w_ffn_k`` / ``w_ffn_v`` run column- /
row-parallel and its gate's columns are all-gathered
(:func:`~repro_torch.nn.sharding.gather_from_tp`) before the product with
the reduced value.  What a rank computes on its part alone enters through
:func:`~repro_torch.nn.sharding.copy_to_tp` (the token-shift mixes fed to
the split products, the decay LoRA's hidden, the cut vectors), so its
partial gradients sum over the model axis; the mixes themselves and their
``mu_*`` / LoRA weights see whole activations and whole gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sites
from repro_torch.kernels import ops

from .layers import rms_norm
from .mlp import fused_act_matmul, fused_matmul_tab, make_activation
from .sharding import copy_to_tp, current_tp, gather_from_tp, reduce_from_tp

# The model's WKV chunk length (the reference's WKV_CHUNK), a lever of the
# dry run's hill climb (repro_torch.launch.hillclimb); on the card a
# chunk K8 cannot take raises (kernels/wkv.py::k8_plan).
WKV_CHUNK = 64


def set_wkv_chunk(c: int) -> None:
    global WKV_CHUNK
    WKV_CHUNK = c


def wkv_scan_ref(q, k, v, log_w, u):
    """Sequential oracle: q, k, v, log_w (B, T, H, N); u (H, N)."""
    b, t, h, n = q.shape
    q, k, v, log_w = (a.float() for a in (q, k, v, log_w))
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=q.device)
    ys = []
    for i in range(t):
        qt, kt, vt, lwt = q[:, i], k[:, i], v[:, i], log_w[:, i]
        y = torch.einsum("bhn,bhnm->bhm", qt, s)
        y = y + torch.einsum("bhn,bhn->bh", qt, u * kt)[..., None] * vt
        s = torch.exp(lwt)[..., None] * s + kt[..., None] * vt[..., None, :]
        ys.append(y)
    return torch.stack(ys, dim=1), s


def wkv_chunked(q, k, v, log_w, u, chunk: int = 16, state=None):
    """Chunkwise-parallel WKV.  Returns ``(y (B, T, H, N) f32, final
    state)``.  Every exponent is <= 0; a ragged T behaves as if padded
    with zero q, k, v and log_w.  A card tensor runs kernel K8, a CPU
    tensor its plain version (:mod:`repro_torch.kernels.wkv`)."""
    return ops.wkv(q, k, v, log_w, u, chunk=chunk, state=state)


def wkv_decode_step(q, k, v, log_w, u, state):
    """One-token decode.  q, k, v, log_w: (B, H, N); state (B, H, N, N)
    f32."""
    y = torch.einsum("bhn,bhnm->bhm", q, state)
    y = y + torch.einsum("bhn,bhn->bh", q, u * k)[..., None] * v
    state = (torch.exp(log_w)[..., None] * state
             + k[..., None] * v[..., None, :])
    return y, state


def _ddlerp(x, x_prev, mu, lora_a, lora_b):
    """RWKV6 data-dependent token-shift interpolation."""
    base = x + (x_prev - x) * mu
    dyn = torch.tanh(torch.matmul(base, lora_a))
    dyn = torch.matmul(dyn, lora_b)
    return x + (x_prev - x) * (mu + dyn)


def rwkv_time_mix(p: dict, x, cfg, x_last=None, wkv_state=None,
                  chunk: int | None = None):
    """RWKV6 attention replacement.  x: (B, T, d).  Returns ``(out,
    (new_x_last, new_wkv_state))``; T == 1 runs the decode recurrence,
    otherwise the chunked-parallel path."""
    chunk = WKV_CHUNK if chunk is None else chunk
    b, t, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    if x_last is None:
        x_last = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)

    mixed = {name: _ddlerp(x, x_prev, p[f"mu_{name}"], p["lora_a"],
                           p[f"lora_b_{name}"])
             for name in ("r", "k", "v", "w", "g")}
    tp = current_tp()
    part = tp is not None and tp.splits("blocks.w_r")
    if part:
        # the rank's heads: its columns lo .. hi of every d-wide vector
        lo = tp.index * p["w_r"].shape[-1]
        cols = slice(lo, lo + p["w_r"].shape[-1])
        h = p["w_r"].shape[-1] // n
        mixed = {name: copy_to_tp(m) if name != "w" else m
                 for name, m in mixed.items()}
        p = dict(p, decay_b=copy_to_tp(p["decay_b"])[:, cols],
                 **{name: copy_to_tp(p[name])[cols]
                    for name in ("decay_base", "bonus", "ln_x")})
        wa = copy_to_tp(torch.tanh(torch.matmul(mixed["w"], p["decay_a"])))
    else:
        wa = torch.tanh(torch.matmul(mixed["w"], p["decay_a"]))
    r = torch.matmul(mixed["r"], p["w_r"])
    k = torch.matmul(mixed["k"], p["w_k"])
    v = torch.matmul(mixed["v"], p["w_v"])
    g = F.silu(torch.matmul(mixed["g"], p["w_g"]))
    w_dyn = torch.matmul(wa, p["decay_b"])
    log_w = -torch.exp(torch.clamp(
        p["decay_base"][None, None] + w_dyn.float(), -8.0, 1.0))

    heads = lambda a: a.reshape(b, t, h, n)
    r_, k_, v_ = heads(r), heads(k), heads(v)
    lw = log_w.reshape(b, t, h, n)
    u = p["bonus"].reshape(h, n)

    if t == 1:
        if wkv_state is None:
            wkv_state = torch.zeros((b, h, n, n), dtype=torch.float32,
                                    device=x.device)
        y, wkv_state = wkv_decode_step(
            r_[:, 0].float(), k_[:, 0].float(), v_[:, 0].float(), lw[:, 0],
            u, wkv_state)
        y = y[:, None]
    else:
        y, wkv_state = wkv_chunked(r_, k_, v_, lw, u, chunk=chunk,
                                   state=wkv_state)

    y = rms_norm(y.reshape(b * t, h, n), p["ln_x"].reshape(h, n),
                 eps=1e-5).reshape(b, t, h * n)
    out = torch.matmul(y.to(x.dtype) * g, p["w_o"])
    if part:
        out = reduce_from_tp(out)
    return out, (x[:, -1:], wkv_state)


def rwkv_channel_mix(p: dict, x, cfg, x_last=None, lut_tables=None,
                     layer: int | None = None):
    """RWKV6 FFN: squared-ReLU with token-shift mixing.  With served
    tables for the ``ffn`` site the squared-ReLU is the layer's compressed
    table; under ``cfg.lut_fuse`` the key projection and the table run as
    one step (kernel K3, non-gated, on the ``"cuda"`` backend)."""
    b, t, d = x.shape
    if x_last is None:
        x_last = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["mu_ffn_k"]
    xr = x + (x_prev - x) * p["mu_ffn_r"]
    tp = current_tp()
    split_k = tp is not None and tp.splits("blocks.w_ffn_k")
    split_r = tp is not None and tp.splits("blocks.w_ffn_r")
    if split_k:
        xk = copy_to_tp(xk)
    ftab = fused_matmul_tab(cfg, lut_tables, sites.FFN, layer)
    if ftab is not None:
        akk = fused_act_matmul(xk, p["w_ffn_k"], ftab, lut_tables,
                               gated=False, site=sites.FFN, layer=layer)
    else:
        act = make_activation(cfg, lut_tables, site=sites.FFN,
                              fallback="relu2", layer=layer)
        akk = act(torch.matmul(xk, p["w_ffn_k"]))
    vv = torch.matmul(akk, p["w_ffn_v"])
    if split_k:
        vv = reduce_from_tp(vv)
    if split_r:
        rr = gather_from_tp(torch.sigmoid(torch.matmul(copy_to_tp(xr),
                                                       p["w_ffn_r"])))
    else:
        rr = torch.sigmoid(torch.matmul(xr, p["w_ffn_r"]))
    return rr * vv, x[:, -1:]
