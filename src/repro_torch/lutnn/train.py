"""Training loop for LUT-NNs (AdamW, eager PyTorch on the device).

Counterpart of the reference's ``lutnn/train.py``: the same loss
(temperature 8, log-softmax, mean NLL), the same warmup-cosine schedule
and AdamW settings, and the batch order drawn from
``np.random.default_rng(cfg.seed + 1)``, so both packages see the same
batches.  Training runs in float32; float32 matrix products on the card
run without TF32 (PyTorch's default, ``torch.backends.cuda.matmul.
allow_tf32 == False``), which this module leaves as it finds it.  The
per-step loss and accuracy stay on the device and are read once per
epoch.  On the card every step after the first few replays one CUDA graph
of :func:`train_step` (:class:`CapturedTrainStep`), with the eager step's
kernels and scalars, so its bits; ``graph=False`` keeps the eager loop.
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
from repro_torch.optim.adamw import adamw_apply, adamw_step_scalars

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


WARMUP_STEPS = 3   # eager steps on a side stream before the capture


class CapturedTrainStep:
    """:func:`train_step` on the card as one CUDA graph replay a step.

    A step is a few hundred small kernels (forward, backward, AdamW per
    parameter), which the host launches slower than the card runs them.
    The first ``WARMUP_STEPS`` steps run eagerly on a side stream (real
    steps, and the warm-up a capture needs); the next one is captured, and
    it and every later step replay that graph on static buffers: the batch
    is gathered into them and the step's ``[1 / c1, 1 / c2, lr]`` is read
    from a table of every step's values made on the host
    (:func:`~repro_torch.optim.adamw.adamw_step_scalars`).  A replay runs
    the eager step's kernels on the eager step's values, so it gives the
    eager loop's bits.  Calls take the batch's row indices into the
    training tensors and return ``(loss, acc)`` as device scalars."""

    def __init__(self, model: LUTNN, opt_state: dict, conn, cfg: LUTNNConfig,
                 opt_cfg: AdamWConfig, x: torch.Tensor, y: torch.Tensor,
                 batch_size: int, total: int):
        dev = x.device
        self.args = (model, opt_state, conn, cfg, opt_cfg)
        self.data = (x, y)
        self.x = torch.empty((batch_size, *x.shape[1:]), dtype=x.dtype,
                             device=dev)
        self.y = torch.empty(batch_size, dtype=y.dtype, device=dev)
        self.table = torch.as_tensor(np.stack([
            adamw_step_scalars(opt_cfg, c) for c in range(1, total + 1)]),
            device=dev)
        self.scalars = torch.empty(3, dtype=torch.float32, device=dev)
        self.clip = None if opt_cfg.grad_clip_norm is None else \
            torch.tensor(np.float32(opt_cfg.grad_clip_norm), device=dev)
        self.side = torch.cuda.Stream(dev)
        self.graph = self.out = None

    def _step(self):
        model, opt_state, conn, cfg, opt_cfg = self.args
        loss, acc = loss_fn(model, conn, cfg, self.x, self.y)
        loss.backward()
        params = list(model.parameters())
        adamw_apply([p.grad for p in params], opt_state, params, opt_cfg,
                    self.clip, *self.scalars)
        return loss.detach(), acc.detach()

    def __call__(self, idx: torch.Tensor):
        model, opt_state, conn, cfg, opt_cfg = self.args
        x, y = self.data
        count = opt_state["count"]
        if count < WARMUP_STEPS:
            here = torch.cuda.current_stream()
            self.side.wait_stream(here)
            with torch.cuda.stream(self.side):
                out = train_step(model, opt_state, conn, cfg, x[idx], y[idx],
                                 opt_cfg)
            here.wait_stream(self.side)
            return out
        if self.graph is None:
            model.zero_grad(set_to_none=True)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self._step()
        torch.index_select(x, 0, idx, out=self.x)
        torch.index_select(y, 0, idx, out=self.y)
        self.scalars.copy_(self.table[count])
        opt_state["count"] = count + 1
        self.graph.replay()
        return tuple(t.clone() for t in self.out)


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
    graph: bool = True,
) -> tuple[LUTNN, list[np.ndarray], dict]:
    """Returns ``(model, connectivity, metrics)``; the model lives on
    ``device`` (the card unless the caller asks for the CPU).  On the card
    the steps replay a CUDA graph (:class:`CapturedTrainStep`) unless
    ``graph=False``."""
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

    captured = None
    if graph and dev.type == "cuda":
        captured = CapturedTrainStep(model, opt_state, conn_t, cfg, opt_cfg,
                                     xd, yd, batch_size, total)

    rng = np.random.default_rng(cfg.seed + 1)
    metrics = {"train_acc": 0.0, "test_acc": None, "loss": None}
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=dev)
        accs, losses = [], []
        for s in range(steps_per_epoch):
            idx = perm[s * batch_size:(s + 1) * batch_size]
            if captured is None:
                loss, acc = train_step(model, opt_state, conn_t, cfg,
                                       xd[idx], yd[idx], opt_cfg)
            else:
                loss, acc = captured(idx)
            accs.append(acc)
            losses.append(loss)
        metrics["train_acc"] = float(np.mean(torch.stack(accs).tolist()))
        metrics["loss"] = float(np.mean(torch.stack(losses).tolist()))
    if captured is not None:
        # the gradients live in the graph's memory pool
        del captured
        model.zero_grad(set_to_none=True)
    if x_test is not None:
        with torch.no_grad():
            scores = lutnn_forward(model, conn_t, cfg,
                                   torch.as_tensor(x_test, device=dev))
        hits = first_argmax(scores) == torch.as_tensor(y_test, device=dev)
        metrics["test_acc"] = float(hits.float().mean())
    return model, conn, metrics
