"""Training loop for LUT-NNs (AdamW, eager PyTorch on the device).

Counterpart of the reference's ``lutnn/train.py``: the same loss
(temperature 8, log-softmax, mean NLL), the same warmup-cosine schedule
and AdamW settings, and the batch order drawn from
``np.random.default_rng(cfg.seed + 1)``, so both packages see the same
batches.  Training runs in float32; float32 matrix products on the card
run without TF32 (PyTorch's default, ``torch.backends.cuda.matmul.
allow_tf32 == False``), which this module leaves as it finds it.  The
per-step loss and accuracy stay on the device and are read once per
epoch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    warmup_cosine_schedule,
)

from .model import (
    LUTNN,
    LUTNNConfig,
    device_tables,
    first_argmax,
    lutnn_forward,
    lutnn_init,
    make_connectivity,
)


def loss_fn(model: LUTNN, conn, cfg: LUTNNConfig, x, y, temp: float = 8.0):
    """``(loss, acc)`` of one batch: mean NLL of ``log_softmax(scores *
    temp)`` and the share of first-argmax hits."""
    scores = lutnn_forward(model, conn, cfg, x)           # (B, C) in [0,1]
    logp = torch.log_softmax(scores * temp, dim=-1)
    loss = -logp.gather(-1, y[:, None].long()).mean()
    acc = (first_argmax(scores) == y).float().mean()
    return loss, acc


def opt_config(lr: float, total: int) -> AdamWConfig:
    """The reference's optimizer settings for ``total`` steps."""
    return AdamWConfig(
        lr=warmup_cosine_schedule(lr, total // 20 + 1, total),
        weight_decay=1e-4,
        grad_clip_norm=1.0,
    )


def train_step(model: LUTNN, opt_state: dict, conn, cfg: LUTNNConfig, x,
               y, opt_cfg: AdamWConfig):
    """One AdamW step on one batch, in place; returns ``(loss, acc)`` as
    device scalars (no host sync)."""
    model.zero_grad(set_to_none=True)
    loss, acc = loss_fn(model, conn, cfg, x, y)
    loss.backward()
    params = list(model.parameters())
    adamw_update([p.grad for p in params], opt_state, params, opt_cfg)
    return loss.detach(), acc.detach()


def train_lutnn(
    cfg: LUTNNConfig,
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_test: np.ndarray | None = None,
    y_test: np.ndarray | None = None,
    epochs: int = 20,
    batch_size: int = 256,
    lr: float = 2e-2,
    device=None,
) -> tuple[LUTNN, list[np.ndarray], dict]:
    """Returns ``(model, connectivity, metrics)``; the model lives on
    ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    conn = make_connectivity(cfg)
    conn_t = device_tables(conn, dev)
    model = lutnn_init(cfg, dev)
    n = x_train.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    total = epochs * steps_per_epoch
    opt_cfg = opt_config(lr, total)
    opt_state = adamw_init(list(model.parameters()))
    xd = torch.as_tensor(x_train, device=dev)
    yd = torch.as_tensor(y_train, device=dev)

    rng = np.random.default_rng(cfg.seed + 1)
    metrics = {"train_acc": 0.0, "test_acc": None, "loss": None}
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=dev)
        accs, losses = [], []
        for s in range(steps_per_epoch):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            loss, acc = train_step(model, opt_state, conn_t, cfg, xd[idx],
                                   yd[idx], opt_cfg)
            accs.append(acc)
            losses.append(loss)
        metrics["train_acc"] = float(np.mean(torch.stack(accs).tolist()))
        metrics["loss"] = float(np.mean(torch.stack(losses).tolist()))
    if x_test is not None:
        with torch.no_grad():
            scores = lutnn_forward(model, conn_t, cfg,
                                   torch.as_tensor(x_test, device=dev))
        hits = first_argmax(scores) == torch.as_tensor(y_test, device=dev)
        metrics["test_acc"] = float(hits.float().mean())
    return model, conn, metrics
