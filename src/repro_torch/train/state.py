"""Train state: parameters, AdamW moments and the step counter (the
reference's ``train/state.py``), on one device or as one rank's shares of
a mesh.

The state is a dict with the reference's keys: ``params`` (the model's
parameter module, trainable), ``opt`` (:func:`repro_torch.optim.
adamw_init` over the parameters in the module's order: ``mu`` and ``nu``
lists and the host ``count``), ``step`` (a host int) and, under
``grad_compress``, ``ef_error`` (float32 error-feedback buffers, one per
parameter).  :mod:`.checkpoint` writes it in the reference's leaf order.

On a mesh (:mod:`repro_torch.launch.mesh`) a rank's state has the same
keys, and each tensor is the rank's share under
:func:`train_state_shardings`: the reference's placements, the
parameters' ``"tp"`` and ``"fsdp"`` (ZeRO-3) axes both kept, the moments
and ``ef_error`` placed as the parameters, the counters replicated.  At
rest a rank holds only its shares (:func:`init_train_state` with a mesh
draws the parameters leaf by leaf into them; :func:`shard_train_state`
cuts them from a full state).  :func:`abstract_train_state` (the
reference's ``eval_shape`` for dry runs) builds the same state without
data.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn import init_params
from repro_torch.nn.sharding import Placement, named_sharding
from repro_torch.nn.transformer import (
    _flat_defs,
    abstract_params,
    param_defs,
    params_class,
)
from repro_torch.optim import AdamWConfig, adamw_init


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    remat: bool = True
    microbatch: int | None = None      # micro-steps per global step
    grad_compress: bool = False        # int8 error-feedback compression
    chunk_q: int = 512                 # attention query-chunk length
    seed: int = 0


def train_param_shardings(cfg: ArchConfig, mesh) -> dict:
    """``{dotted name: Placement}`` of every parameter at rest in
    training: the reference's ``param_specs(cfg, mesh)`` (``fsdp=True``),
    each ``"tp"`` and ``"fsdp"`` axis of ``param_defs`` kept, a dim the
    axes do not divide replicated."""
    return {name: named_sharding(mesh, *(d.axes or (None,) * len(d.shape)),
                                 shape=d.shape)
            for name, d, _ in _flat_defs(param_defs(cfg))}


def train_state_shardings(cfg: ArchConfig, tcfg: TrainConfig, mesh) -> dict:
    """The placements of a train state on ``mesh``, in its nesting: the
    moments (and ``ef_error``) follow the parameters, so the update needs
    no resharding; the counters are replicated."""
    pl = train_param_shardings(cfg, mesh)
    rep = Placement(mesh, ())
    out = {"params": pl, "opt": {"mu": pl, "nu": pl, "count": rep},
           "step": rep}
    if tcfg.grad_compress:
        out["ef_error"] = pl
    return out


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, device=None,
                     mesh=None) -> dict:
    """A fresh state: parameters from ``tcfg.seed`` (the port's
    generator: :func:`repro_torch.bridge.train_state_from_jax` copies the
    reference's instead), zero moments, step 0.  With a ``mesh``, this
    rank's shares of the same state: each parameter drawn leaf by leaf
    (a stack layer by layer) and cut to its share, so no rank holds the
    whole model.  The device defaults to the mesh's (the rank's card)."""
    if mesh is None:
        return state_for(init_params(cfg, tcfg.seed, device), tcfg)
    from repro_torch.serve.sharded import init_params_sharded

    return state_for(init_params_sharded(
        cfg, tcfg.seed, mesh,
        resolve_device(device if device is not None else mesh.device),
        placements=train_param_shardings(cfg, mesh)), tcfg)


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig,
                         device="meta", mesh=None) -> dict:
    """:func:`init_train_state` without data (the reference's
    ``eval_shape`` for dry runs): the same keys, leaves, shapes and dtypes
    (a rank's shares with a ``mesh``) on the ``meta`` device, or as fake
    tensors on any device inside a ``FakeTensorMode``; nothing allocated,
    and the draws skipped (:func:`~repro_torch.nn.transformer.
    abstract_params`)."""
    return state_for(abstract_params(
        cfg, device, None if mesh is None
        else train_param_shardings(cfg, mesh)), tcfg)


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


def shard_train_state(state: dict, cfg: ArchConfig, mesh) -> dict:
    """This rank's shares of a full train state (one device's, or
    :func:`repro_torch.bridge.train_state_from_jax`'s), cut by
    :func:`train_state_shardings`: a new state; the caller may free the
    full one."""
    pl = train_param_shardings(cfg, mesh)
    named = list(state["params"].named_parameters())
    cut = lambda ts: [pl[n].local(t.detach()) for (n, _), t in zip(named, ts)]
    params = params_class(cfg)(
        cfg, named[0][1].device,
        leaves={n: pl[n].local(p.detach()) for n, p in named})
    out = {"params": params.requires_grad_(True),
           "opt": {"mu": cut(state["opt"]["mu"]),
                   "nu": cut(state["opt"]["nu"]),
                   "count": state["opt"]["count"]},
           "step": state["step"]}
    if "ef_error" in state:
        out["ef_error"] = cut(state["ef_error"])
    return out
