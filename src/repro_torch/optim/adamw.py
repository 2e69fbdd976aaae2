"""AdamW with global-norm clipping on lists of tensors.

Own copy of the reference's ``optim/adamw.py`` in the reference's
association: clip scale ``min(1, c / (||g|| + 1e-9))``, moments
``b * m + (1 - b) * g``, step ``mhat / (sqrt(vhat) + eps)`` with the weight
decay added to the step, and the update ``p - lr * step`` in float32.
(``torch.optim.AdamW`` computes ``p * (1 - lr * wd)`` and
``sqrt(v) / sqrt(c2) + eps``: another association, other bits.)

Unlike the reference, which returns new trees, :func:`adamw_update`
updates the parameters and the moments in place, a leaf above
``ADAMW_CHUNK`` elements in slices along its leading axis (one layer of a
stacked leaf): the update is elementwise, so the slices give the whole
leaf's bits, and the step's memory is the parameters', the moments' and
one slice's temporaries (XLA fuses the reference's update).  The step
count stays on the host, so the learning rate and the bias corrections
are float32 scalars computed there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

_F = np.float32

# elements: a leaf above this is updated a slice of its leading axis at a
# time, each slice of at most this many elements or one row
ADAMW_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable[[int], Any] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: float | None = 1.0

    def lr_at(self, step: int) -> np.float32:
        if callable(self.lr):
            return _F(self.lr(step))
        return _F(self.lr)


def adamw_init(params: list[torch.Tensor]) -> dict:
    return {"mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
            "count": 0}


def square_sum(t: torch.Tensor) -> torch.Tensor:
    """One leaf's term of :func:`global_norm`."""
    return torch.sum(torch.square(t.float()))


def slab_square_sums(t: torch.Tensor) -> torch.Tensor:
    """The ``(L, E)`` float32 :func:`square_sum` of each ``t[l, e]`` of a
    stack ``(L, E, ...)`` (a moe expert stack's term of the norm), one
    slab at a time: the same call on a slab of the same shape, so a rank's
    share ``(L, E / tp, ...)`` gives its experts' entries bit for bit the
    whole stack's, and no float32 copy of more than one slab is made."""
    L, E = t.shape[:2]
    return torch.stack([square_sum(t[i, e]) for i in range(L)
                        for e in range(E)]).view(L, E)


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """``sqrt(0 + s_0 + s_1 + ...)`` over the leaves' :func:`square_sum`
    in order (the train step adds the same terms, a moe expert stack's
    from :func:`slab_square_sums`, and hands the norm to
    :func:`adamw_update`)."""
    return torch.sqrt(sum(square_sum(t) for t in tensors))


@torch.no_grad()
def adamw_update(grads: list[torch.Tensor], state: dict,
                 params: list[torch.Tensor], cfg: AdamWConfig,
                 gnorm: torch.Tensor | None = None) -> dict:
    """One AdamW step, in place on ``params`` and ``state``.  Returns the
    metrics ``{"grad_norm": tensor, "lr": float32}``.  ``gnorm``: the
    gradients' global norm when ``grads`` are a rank's shares of them (a
    sharded step takes it over the full gradients; shares are not normed
    alone)."""
    state["count"] += 1
    count = state["count"]
    clip = None
    if cfg.grad_clip_norm is not None:
        # tensor / tensor: PyTorch's scalar / tensor is a reciprocal and a
        # multiply, another rounding than the reference's division
        clip = torch.tensor(_F(cfg.grad_clip_norm), device=grads[0].device)
    c1 = float(_F(1) - _F(cfg.b1) ** _F(count))
    c2 = float(_F(1) - _F(cfg.b2) ** _F(count))
    lr = cfg.lr_at(count)
    gnorm = adamw_apply(grads, state, params, cfg, clip, c1, c2, float(lr),
                        gnorm=gnorm)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_step_scalars(cfg: AdamWConfig, count: int) -> np.ndarray:
    """``[1 / c1, 1 / c2, lr]`` of step ``count`` as float32, for
    :func:`adamw_apply` inside a captured CUDA graph: a CUDA tensor
    divided by a Python float ``c`` is multiplied by the float32 ``1 /
    c``, so these give :func:`adamw_update`'s bits on the card."""
    c1 = _F(1) - _F(cfg.b1) ** _F(count)
    c2 = _F(1) - _F(cfg.b2) ** _F(count)
    return np.array([_F(1) / c1, _F(1) / c2, cfg.lr_at(count)],
                    dtype=np.float32)


@torch.no_grad()
def adamw_apply(grads: list[torch.Tensor], state: dict,
                params: list[torch.Tensor], cfg: AdamWConfig, clip,
                c1, c2, lr, gnorm: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The update of :func:`adamw_update` with its step's values given:
    ``clip`` the clip norm as a tensor on the grads' device (or None),
    ``c1`` / ``c2`` the bias corrections and ``lr`` as Python floats, or
    as 0-d float32 tensors on the card holding ``1 / c1``, ``1 / c2`` and
    ``lr`` (:func:`adamw_step_scalars`), which a captured graph reads
    afresh at each replay.  Returns the gradients' global norm, ``gnorm``
    when given (see :func:`adamw_update`)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = None
    if clip is not None:
        scale = torch.minimum(torch.ones_like(gnorm),
                              clip / (gnorm + 1e-9))
    # tensors c1, c2 hold the reciprocals
    div = torch.mul if torch.is_tensor(c1) else torch.div
    b1, b2 = cfg.b1, cfg.b2
    for leaf in zip(params, grads, state["mu"], state["nu"]):
        for p, g, m, v in zip(*map(_chunks, leaf)):
            if scale is not None:
                g = g * scale
            m.copy_(b1 * m + (1 - b1) * g.to(m.dtype))
            v.copy_(b2 * v + (1 - b2) * torch.square(g.to(v.dtype)))
            step = div(m, c1) / (torch.sqrt(div(v, c2)) + cfg.eps)
            if cfg.weight_decay > 0:
                step = step + cfg.weight_decay * p.to(step.dtype)
            p.copy_((p.float() - lr * step).to(p.dtype))
    return gnorm


def _chunks(t: torch.Tensor) -> tuple:
    """``t`` whole up to ``ADAMW_CHUNK`` elements, else views of slices
    along dim 0, each of ``ADAMW_CHUNK`` elements or fewer (one row when
    a row is larger)."""
    if t.numel() <= ADAMW_CHUNK:
        return (t,)
    return torch.split(t, max(1, ADAMW_CHUNK // (t.numel() // t.shape[0])))
