"""LUT-NN model definition: sparse connectivity + per-neuron sub-networks.

Counterpart of the reference's ``lutnn/model.py``.  Each neuron absorbs a
small MLP over its F dequantized parent activations (NeuraLUT, paper
Table 1); activations are quantized to ``beta`` bits on a uniform [0, 1]
grid with a straight-through estimator.  After training every neuron is
enumerable as a ``2^(beta*F) -> 2^beta`` truth table.

:class:`LUTNNConfig`, :func:`paper_model` and :func:`make_connectivity`
(numpy RNG) are own copies and give the reference's configurations and
wiring.  :class:`LUTNN` holds each layer's ``w1 (n, F, h)``, ``b1 (n, h)``,
``w2 (n, h)``, ``b2 (n,)`` under the reference's names; it is initialised
from a ``torch.Generator`` with the reference's distributions (other bits
than ``jax.random``: :func:`repro_torch.bridge.lutnn_params_from_jax`
carries a reference parameter tree across exactly).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LUTNNConfig:
    name: str
    n_inputs: int                 # raw feature count (e.g. 784 / 16)
    layer_sizes: tuple[int, ...]  # neurons per layer, last = classes
    beta: int                     # hidden activation bits
    fanin: int                    # hidden fan-in F
    beta0: int                    # input activation bits
    fanin0: int                   # input-layer fan-in F0
    hidden_width: int = 4         # width of the in-neuron MLP (NeuraLUT)
    seed: int = 0

    def layer_w_in(self, layer: int) -> int:
        return (self.beta0 * self.fanin0) if layer == 0 else (self.beta * self.fanin)

    def layer_beta_in(self, layer: int) -> int:
        return self.beta0 if layer == 0 else self.beta

    def layer_fanin(self, layer: int) -> int:
        return self.fanin0 if layer == 0 else self.fanin

    @property
    def n_luts(self) -> int:
        return sum(self.layer_sizes)


def make_connectivity(cfg: LUTNNConfig) -> list[np.ndarray]:
    """Fixed random sparse wiring: conn[l] has shape (n_l, F_l)."""
    rng = np.random.default_rng(cfg.seed)
    conn = []
    prev = cfg.n_inputs
    for l, n in enumerate(cfg.layer_sizes):
        f = cfg.layer_fanin(l)
        rows = np.stack([
            rng.choice(prev, size=f, replace=(prev < f)) for _ in range(n)
        ])
        conn.append(rows.astype(np.int32))
        prev = n
    return conn


def device_tables(arrays, device) -> list[torch.Tensor]:
    """Per-layer integer arrays (wiring, truth tables; numpy or tensors)
    as contiguous int32 tensors on ``device``."""
    return [torch.as_tensor(a, device=device).to(torch.int32).contiguous()
            for a in arrays]


def first_argmax(scores: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis, as ``np.argmax`` /
    ``jnp.argmax`` break ties (quantized scores tie often)."""
    top = scores.amax(dim=-1, keepdim=True)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    return torch.where(scores == top, idx, scores.shape[-1]).amin(dim=-1)


class LUTNNLayer(nn.Module):
    """One layer's private per-neuron MLPs (``n`` neurons, fan-in ``f``,
    hidden width ``h``)."""

    def __init__(self, n: int, f: int, h: int, device=None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(n, f, h, device=device))
        self.b1 = nn.Parameter(torch.zeros(n, h, device=device))
        self.w2 = nn.Parameter(torch.empty(n, h, device=device))
        self.b2 = nn.Parameter(torch.zeros(n, device=device))


class LUTNN(nn.Module):
    """Parameters of a LUT-NN; ``layers.{l}.{w1,b1,w2,b2}`` mirror the
    reference's ``params["layers"][l][...]``."""

    def __init__(self, cfg: LUTNNConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            LUTNNLayer(n, cfg.layer_fanin(l), cfg.hidden_width, device)
            for l, n in enumerate(cfg.layer_sizes))


def lutnn_init(cfg: LUTNNConfig, device=None) -> LUTNN:
    """A LUT-NN with ``w1 ~ N(0, 1) * 2/sqrt(F)``, ``w2 ~ N(0, 1) *
    2/sqrt(h)`` and zero biases, drawn on the CPU from a generator seeded
    with ``cfg.seed`` (the same numbers on every device)."""
    dev = resolve_device(device)
    model = LUTNN(cfg, dev)
    gen = torch.Generator().manual_seed(cfg.seed)
    with torch.no_grad():
        for l, layer in enumerate(model.layers):
            f, h = cfg.layer_fanin(l), cfg.hidden_width
            layer.w1.copy_(torch.randn(layer.w1.shape, generator=gen)
                           * float(2.0 / np.sqrt(f)))
            layer.w2.copy_(torch.randn(layer.w2.shape, generator=gen)
                           * float(2.0 / np.sqrt(h)))
    return model


def quantize_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform [0,1] quantization with a straight-through gradient
    (``torch.round`` rounds half to even, as ``jnp.round``)."""
    levels = (1 << bits) - 1
    xq = torch.round(torch.clamp(x, 0.0, 1.0) * levels) / levels
    return x + (xq - x).detach()


def neuron_eval(layer: LUTNNLayer, inputs: torch.Tensor) -> torch.Tensor:
    """Evaluate every neuron of a layer on its gathered inputs.

    ``inputs``: (..., n, F) dequantized parent activations in [0, 1].
    Returns (..., n) pre-quantization activations in [0, 1].
    """
    z = torch.einsum("...nf,nfh->...nh", inputs, layer.w1)
    z = torch.relu(z + layer.b1)
    z = torch.einsum("...nh,nh->...n", z, layer.w2) + layer.b2
    return torch.sigmoid(z)


def lutnn_forward(
    model: LUTNN,
    conn: list[torch.Tensor],
    cfg: LUTNNConfig,
    x: torch.Tensor,
    quantized: bool = True,
) -> torch.Tensor:
    """Training-time forward pass. Returns (..., n_classes) scores in [0,1].

    ``conn`` holds index tensors on ``x``'s device (:func:`device_tables`).
    With ``quantized=True`` (default) this computes exactly the function the
    extracted truth tables tabulate.
    """
    h = quantize_ste(x, cfg.beta0) if quantized else x
    for l, layer in enumerate(model.layers):
        a = neuron_eval(layer, h[..., conn[l]])   # gathered: (..., n_l, F_l)
        if quantized:
            a = quantize_ste(a, cfg.beta)
        h = a
    return h


# ----------------------------------------------------------------------
# Paper Table 1 model zoo
# ----------------------------------------------------------------------
PAPER_MODELS = ("jsc-2l", "jsc-5l", "mnist")


def paper_model(name: str, seed: int = 0) -> LUTNNConfig:
    if name == "jsc-2l":
        return LUTNNConfig(
            name=name, n_inputs=16, layer_sizes=(32, 5),
            beta=4, fanin=3, beta0=4, fanin0=3, seed=seed,
        )
    if name == "jsc-5l":
        return LUTNNConfig(
            name=name, n_inputs=16, layer_sizes=(128, 128, 128, 64, 5),
            beta=4, fanin=3, beta0=7, fanin0=2, seed=seed,
        )
    if name == "mnist":
        return LUTNNConfig(
            name=name, n_inputs=784, layer_sizes=(256, 100, 100, 100, 10),
            beta=2, fanin=6, beta0=2, fanin0=6, seed=seed,
        )
    raise KeyError(f"unknown paper model {name!r}")
