"""Mixture-of-Experts feed-forward (PyTorch port of the single-device
branch of the reference's ``nn/moe.py``).

Every token picks ``top_k`` experts from a float32 router; the picks are
sorted by expert id and each expert takes the first ``capacity`` of its
tokens into a fixed ``(E, C, d)`` buffer (sort-based, no ``(S, E, C)``
one-hot).  The expert products run over every expert's whole capacity,
empty slots included, as in the reference; assignments past an expert's
capacity are dropped and add nothing.

The routing keeps the reference's choices bit for bit and reads nothing
back to the host, so a decode step that routes can be captured in a CUDA
graph (:mod:`repro_torch.serve.graphs`):

* **Top-k.** ``jax.lax.top_k`` takes the lower expert id on a tie;
  ``torch.topk`` does not promise an order among equal values.  A stable
  descending sort sliced to ``k`` does what the reference does.
* **Rank in an expert.** ``jnp.argsort`` is stable; ``torch.argsort`` is
  only with ``stable=True``.  A token's rank in its expert, and so which
  assignments overflow ``capacity``, depends on it.
* **Counts.** A fixed-size ``scatter_add_`` of ones (``torch.bincount``
  reads its maximum back to the host on the card).
* **Combine.** Each token's contributions are added one after another in
  ascending expert id, the order in which the reference scatters them;
  no atomic accumulation (``index_add_`` on the card sums a token's bf16
  contributions in a varying order, so its bits would vary run to run).

The two expert-parallel branches of the reference (under a mesh) wait for
sharded serving (ROADMAP queue A, item 11).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import sites

from .mlp import make_activation


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def moe_capacity(n_tokens: int, moe) -> int:
    """Slots per expert for ``n_tokens`` routed tokens: the reference's
    formula, character for character."""
    return _round_up(
        max(int(n_tokens * moe.top_k / moe.n_experts * moe.capacity_factor),
            moe.top_k), 8)


@dataclasses.dataclass
class Routing:
    """Where each of the ``S * k`` assignments goes, in expert-sorted
    order (the reference's ``order`` / ``slot`` / ``local``)."""

    probs: torch.Tensor       # (S, E) float32 router probabilities
    top_p: torch.Tensor       # (S, k) renormalized weights of the picks
    top_ids: torch.Tensor     # (S, k) expert ids, descending probability
    order: torch.Tensor       # (S*k,) assignment index, sorted by expert
    slot: torch.Tensor        # (S*k,) buffer row, E*C for a dropped one
    keep: torch.Tensor        # (S*k,) bool: within its expert's capacity
    counts: torch.Tensor      # (E,) int64 assignments per expert

    def dropped(self) -> torch.Tensor:
        """Assignments dropped by capacity, as a 0-d tensor (no sync)."""
        return (~self.keep).sum()


def route(x: torch.Tensor, router_w: torch.Tensor, *, n_experts: int,
          top_k: int, capacity: int) -> Routing:
    """Route ``x`` (S, d) over ``n_experts`` experts of ``capacity``
    slots: top-k of the float32 softmax, ties to the lower id."""
    s = x.shape[0]
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_ids = top_p[:, :top_k], top_ids[:, :top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    flat_ids = top_ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.zeros(n_experts, dtype=torch.long, device=x.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(s * top_k, device=x.device) - starts[sorted_ids]
    keep = rank < capacity
    slot = torch.where(keep, sorted_ids * capacity + rank,
                       n_experts * capacity)
    return Routing(probs, top_p, top_ids, order, slot, keep, counts)


def moe_ffn_local(x: torch.Tensor, router_w: torch.Tensor,
                  w_in: torch.Tensor, w_out: torch.Tensor, *,
                  n_experts: int, top_k: int, capacity: int, act_fn=None):
    """Route + gather + expert products + weighted combine of ``x`` (S,
    d) over all experts (``w_in`` (E, d, 2f) fused gate|up, ``w_out`` (E,
    f, d); ``act_fn`` the gate's activation, SiLU by default): ``(y (S,
    d), aux)``, ``aux`` the Switch-style load-balance loss (float32,
    0-d)."""
    s, d = x.shape
    r = route(x, router_w, n_experts=n_experts, top_k=top_k,
              capacity=capacity)
    src = r.order // top_k                                 # token index
    # one spare row takes every dropped assignment and is discarded
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[r.slot] = x[src]
    tokens = buf[:-1].view(n_experts, capacity, d)

    act = act_fn if act_fn is not None else F.silu
    gate, up = torch.matmul(tokens, w_in).chunk(2, dim=-1)
    y_exp = torch.matmul(act(gate) * up, w_out)
    y_flat = torch.cat([y_exp.reshape(n_experts * capacity, d),
                        y_exp.new_zeros((1, d))])

    # per token, its k assignments in ascending expert id
    slot_tok = torch.empty_like(r.slot)
    slot_tok[r.order] = r.slot
    by_id = torch.argsort(r.top_ids, dim=-1)
    slots = slot_tok.view(s, top_k).gather(1, by_id)
    keep = (slots < n_experts * capacity).to(torch.float32)
    weights = (r.top_p.gather(1, by_id) * keep).to(x.dtype)
    contrib = y_flat[slots] * weights[..., None]           # (S, k, d)
    y = torch.zeros((s, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        y = y + contrib[:, j]

    frac = r.counts.float() / (s * top_k)
    imp = r.probs.mean(dim=0)
    aux = n_experts * torch.sum(frac * imp)
    return y, aux


def moe_block(params: dict, x: torch.Tensor, cfg, shared_mlp=None,
              lut_tables=None, layer: int | None = None):
    """(B, T, d) -> ((B, T, d), aux).  The per-expert gated activation is
    the ``expert`` site: its compressed table for ``layer`` when served
    (kernels K1 / K2 / K4 on the card), and seen by an active calibration
    capture, empty capacity slots included.  ``shared_mlp``: the shared
    experts, added to the routed output."""
    b, t, d = x.shape
    m = cfg.moe
    act_fn = make_activation(cfg, lut_tables, site=sites.EXPERT,
                             fallback="silu", layer=layer)
    y, aux = moe_ffn_local(
        x.reshape(-1, d), params["router"], params["w_in"],
        params["w_out"], n_experts=m.n_experts, top_k=m.top_k,
        capacity=moe_capacity(b * t, m), act_fn=act_fn)
    y = y.reshape(b, t, d)
    if shared_mlp is not None:
        y = y + shared_mlp(x)
    return y, aux
