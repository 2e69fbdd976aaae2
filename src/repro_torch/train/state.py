"""Train state: parameters, AdamW moments and the step counter (the
reference's ``train/state.py`` on one device).

The state is a dict with the reference's keys: ``params`` (the model's
parameter module, trainable), ``opt`` (:func:`repro_torch.optim.
adamw_init` over the parameters in the module's order: ``mu`` and ``nu``
lists and the host ``count``), ``step`` (a host int) and, under
``grad_compress``, ``ef_error`` (float32 error-feedback buffers, one per
parameter).  :mod:`.checkpoint` writes it in the reference's leaf order.
The sharded forms (``train_state_shardings``, ``abstract_train_state``)
wait for sharded training and dry runs (ROADMAP queue A, items 11, 12).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import init_params
from repro_torch.optim import AdamWConfig, adamw_init


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    remat: bool = True
    microbatch: int | None = None      # micro-steps per global step
    grad_compress: bool = False        # int8 error-feedback compression
    chunk_q: int = 512                 # attention query-chunk length
    seed: int = 0


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, device=None
                     ) -> dict:
    """A fresh state: parameters from ``tcfg.seed`` (the port's
    generator: :func:`repro_torch.bridge.train_state_from_jax` copies the
    reference's instead), zero moments, step 0."""
    return state_for(init_params(cfg, tcfg.seed, device), tcfg)


def state_for(params: torch.nn.Module, tcfg: TrainConfig) -> dict:
    """The train state around existing parameters, which it makes
    trainable (serving builds them frozen); the moments and ``ef_error``
    follow the module's parameter order."""
    plist = list(params.requires_grad_(True).parameters())
    state = {"params": params, "opt": adamw_init(plist), "step": 0}
    if tcfg.grad_compress:
        state["ef_error"] = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in plist]
    return state
