"""RecurrentGemma / Griffin recurrent block: depthwise causal conv + RG-LRU
(PyTorch port of the reference's ``nn/rglru.py``, same operation order and
type promotion).

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_a u_t),  i_t = sigmoid(W_x u_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Over a segment the diagonal recurrence runs as a log-depth scan that
associates as ``jax.lax.associative_scan`` does (odd/even recursion), so a
prefill of T tokens costs about ``2 log2 T`` rounds of elementwise
kernels, not T.  Decode is the single-step form.

Types follow the reference's promotion, which the float32 smoke configs
hide: ``softplus(Lambda)`` and its scaling by ``-c`` are computed in the
parameter dtype (bf16 at full width, each operation rounded as
``jnp.logaddexp`` rounds it) before the float32 ``r`` widens the product;
``u`` (float32) meets the bf16 ``W_a`` / ``W_x`` in float32; the conv
multiplies and sums in the model dtype, one rounding per operation.

In a partitioned train step (:func:`~repro_torch.nn.sharding.use_tp`)
that splits the block's ``w_in``, a rank runs :func:`recurrent_block` on
its ``d_rnn / tp`` channels: ``w_in`` / ``w_gate`` / ``conv_w`` / ``lam``
and the columns of ``w_a`` / ``w_x`` are its shares, ``x`` enters through
:func:`~repro_torch.nn.sharding.copy_to_tp`, the conv output is
all-gathered into the gate products by
:func:`~repro_torch.nn.sharding.gather_to_tp` (their input is every
channel), the conv and the scan run on the rank's channels, and ``w_out``
is row-parallel (:func:`~repro_torch.nn.sharding.reduce_from_tp`).
"""
from __future__ import annotations

import torch

from .layers import activation_fn
from .sharding import copy_to_tp, current_tp, gather_to_tp, reduce_from_tp

RG_LRU_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in ``x``'s dtype, one
    rounding per operation as the reference computes it in bf16
    (``F.softplus`` rounds once, which differs in the last bit)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two (JAX's promotion: a
    float32 ``a`` against bf16 weights contracts in float32)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(dt), w.to(dt))


def _log_a(params, u):
    """``(r, i, log a)`` of the RG-LRU for float32 ``u``, the gate
    products' input (every channel)."""
    r = torch.sigmoid(_mm(u, params["w_a"]))
    i = torch.sigmoid(_mm(u, params["w_x"]))
    log_a = ((-RG_LRU_C * _softplus(params["lam"])) * r).float()
    return r, i, log_a


def _lru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` over axis 1 of (B, T, D), by
    ``jax.lax.associative_scan``'s recursion with the reference's combine
    ``(la1 + la2, exp(la2) * b1 + b2)``: the same association, so the same
    roundings.  Only the ``b`` half of the scan is an output, and the
    summed ``log_a`` it needs is that of each reduced level."""
    n = b.shape[1]
    if n < 2:
        return b
    la2 = log_a[:, 1::2]
    reduced = torch.exp(la2) * b[:, 0:-1:2] + b[:, 1::2]
    odd = _lru_scan(log_a[:, 0:-1:2] + la2, reduced)
    tail_la, tail_b = log_a[:, 2::2], b[:, 2::2]
    even = torch.exp(tail_la) * odd[:, :tail_b.shape[1]] + tail_b
    even = torch.cat([b[:, :1], even], dim=1)
    out = torch.empty_like(b)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def rg_lru(params, u: torch.Tensor, h_prev: torch.Tensor | None = None,
           gate_in: torch.Tensor | None = None):
    """u: (B, T, D) float32.  Returns (h (B, T, D), last state (B, D)).
    ``gate_in``: the input of the ``W_a`` / ``W_x`` products where it is
    not ``u`` (a partitioned step: ``u`` the rank's channels, ``gate_in``
    all of them)."""
    _, i, log_a = _log_a(params, u if gate_in is None else gate_in)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6, 1.0))
    b = gated * (i * u).float()
    if h_prev is not None:
        # fold the carried state into step 0's additive term
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1]) * h_prev[:, None],
                       b[:, 1:]], dim=1)
    h = _lru_scan(log_a, b)
    return h, h[:, -1]


def rg_lru_step(params, u: torch.Tensor, h_prev: torch.Tensor):
    """Single decode step.  u: (B, D) float32; h_prev: (B, D) float32."""
    _, i, log_a = _log_a(params, u)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-6, 1.0))
    h = a * h_prev + gated * (i * u).float()
    return h, h


def causal_conv1d(w: torch.Tensor, x: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  w: (K, D); x: (B, T, D); state: (B, K-1, D)
    trailing inputs of the previous segment (zeros when ``None``).
    Returns (out (B, T, D), new state (B, K-1, D))."""
    k, t = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return out, xp[:, -(k - 1):]


def recurrent_block(params, x: torch.Tensor, cfg, state: dict | None = None,
                    tp_leaf: str | None = None):
    """Griffin recurrent temporal block over a segment.  x: (B, T, d);
    ``state``: ``None`` (a fresh segment) or ``{"conv": (B, K-1, drnn),
    "lru": (B, drnn)}``.  Returns (out (B, T, d), new state).  In a
    partitioned train step that splits the leaf ``params["w_in"]`` is
    (``tp_leaf``, its dotted name) the block runs on the rank's channels
    (module docstring); training keeps no state."""
    tp = current_tp()
    split = tp is not None and tp.splits(tp_leaf)
    if split:
        x = copy_to_tp(x)
    state = state or {}
    branch = torch.matmul(x, params["w_in"])
    branch, conv_state = causal_conv1d(params["conv_w"], branch,
                                       state.get("conv"))
    u = branch.float()
    h, lru_state = rg_lru(params, u, state.get("lru"),
                          gather_to_tp(u) if split else None)
    gate = activation_fn("gelu")(torch.matmul(x, params["w_gate"]))
    out = torch.matmul(h.to(x.dtype) * gate, params["w_out"])
    if split:
        out = reduce_from_tp(out)
    return out, {"conv": conv_state, "lru": lru_state}


def recurrent_block_step(params, x: torch.Tensor, cfg, state: dict):
    """Single-token decode of the recurrent block.  x: (B, 1, d).  The
    state's ``conv`` window and ``lru`` vector are updated in place (a
    step captured in a CUDA graph writes the buffers the next replay
    reads); returns (out (B, 1, d), state)."""
    branch = torch.matmul(x, params["w_in"])[:, 0]
    xp = torch.cat([state["conv"], branch[:, None]], dim=1)
    w = params["conv_w"]
    conv = xp[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        conv = conv + xp[:, i] * w[i]
    h, lru_state = rg_lru_step(params, conv.float(), state["lru"])
    gate = activation_fn("gelu")(torch.matmul(x, params["w_gate"]))[:, 0]
    out = torch.matmul(h.to(x.dtype) * gate, params["w_out"])
    state["conv"].copy_(xp[:, 1:])
    state["lru"].copy_(lru_state)
    return out[:, None], state
