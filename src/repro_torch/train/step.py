"""The train step on one device (the reference's ``train/step.py``).

:func:`make_train_step` returns ``step(state, batch) -> (state,
metrics)``: the family's loss (:func:`repro_torch.nn.transformer.loss_fn`)
and its gradients by autograd, ``remat`` as activation checkpointing per
layer, microbatches as a Python loop that sums the gradients in float32
and divides by ``microbatch`` (the reference's ``lax.scan`` with float32
accumulators), the single-device form of the int8 error-feedback
compression under ``grad_compress``, and :func:`repro_torch.optim.
adamw_update` in place.  The metrics are the reference's: ``loss``,
``grad_norm`` (0-d tensors, no host read) and ``lr`` (float32).

Serving's counterparts of the reference's ``make_serve_step`` and
``make_prefill`` are :func:`repro_torch.serve.decode_step` (captured in a
CUDA graph by :class:`repro_torch.serve.CapturedStep`) and
:func:`repro_torch.serve.prefill`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import lm_batch_specs
from repro_torch.device import resolve_device
from repro_torch.nn.transformer import loss_fn
from repro_torch.optim import adamw_update

from .compression import compressed_mean_local
from .state import TrainConfig


def input_batch_specs(cfg: ArchConfig, global_batch: int, seq_len: int
                      ) -> dict[str, tuple]:
    """``{name: (shape, numpy dtype)}`` of a training batch: tokens and
    labels, vlm's patch embeddings, encdec's audio frames."""
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((global_batch, cfg.n_patches, cfg.d_model),
                            np.dtype(np.float32))
    if cfg.family == "encdec":
        extra["frames"] = ((global_batch, cfg.n_frames, cfg.d_model),
                           np.dtype(np.float32))
    return lm_batch_specs(global_batch, seq_len, extra)


def batch_to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch on ``device``: integer leaves as int64
    (indices), float leaves as float32."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        dt = torch.long if not t.is_floating_point() else torch.float32
        out[name] = t.to(device=device, dtype=dt)
    return out


def _split_micro(batch: dict, n_micro: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"microbatch {n_micro} does not divide the batch "
                         f"of {b}")
    m = b // n_micro
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n_micro)]


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device=None,
                    lut_tables=None):
    """``step(state, batch) -> (state, metrics)``, updating ``state`` in
    place.  ``lut_tables`` (compressed activations in the forward) must use
    the ``gather`` backend: the kernels' entries have no gradient (neither
    have the reference's Pallas entries)."""
    dev = resolve_device(device)
    if lut_tables is not None and lut_tables.get("backend") != "gather":
        raise ValueError(
            f"make_train_step: LUT tables on the "
            f"{lut_tables.get('backend')!r} backend have no gradient; "
            f"train with backend 'gather'")
    base_loss = loss_fn(cfg)
    n_micro = tcfg.microbatch or 1

    def loss_of(params, batch):
        return base_loss(params, batch=batch, remat=tcfg.remat,
                         chunk_q=tcfg.chunk_q, lut_tables=lut_tables)

    def grads(loss, plist):
        # a parameter the loss does not reach (vlm's patch_proj without
        # patches) gets zeros, as jax.grad gives it
        return list(torch.autograd.grad(loss, plist, allow_unused=True,
                                        materialize_grads=True))

    def grads_of(params, batch):
        plist = list(params.parameters())
        if n_micro == 1:
            loss = loss_of(params, batch)
            return loss.detach(), grads(loss, plist)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in plist]
        losses = []
        for mb in _split_micro(batch, n_micro):
            loss = loss_of(params, mb)
            for a, g in zip(acc, grads(loss, plist)):
                a.add_(g.float())
            losses.append(loss.detach())
        div = torch.tensor(n_micro, dtype=torch.float32, device=dev)
        return torch.mean(torch.stack(losses)), [a / div for a in acc]

    def step(state: dict, batch: dict):
        batch = batch_to_device(batch, dev)
        params = state["params"]
        loss, g = grads_of(params, batch)
        if tcfg.grad_compress:
            g, new_error = compressed_mean_local(g, state["ef_error"])
            state["ef_error"] = new_error
        metrics = adamw_update(g, state["opt"], list(params.parameters()),
                               tcfg.optimizer)
        state["step"] += 1
        return state, {"loss": loss, **metrics}

    return step
