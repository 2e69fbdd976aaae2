"""Carry the reference package's artifacts into the port, bit for bit.

The inputs are plain numpy trees — ``jax.tree.map(np.asarray, tree)`` on
the reference side — so this module imports nothing of JAX.

* :func:`params_from_jax` — a reference parameter tree (decoder, RWKV6
  or hybrid) -> :class:`~repro_torch.nn.DecoderParams` /
  :class:`~repro_torch.nn.RWKVParams` / :class:`~repro_torch.nn.
  HybridParams`; names and stacked layouts are the same (the hybrid's
  nested ``groups`` / ``tail`` trees, vlm's ``patch_proj``), so every
  leaf is copied without renaming (bf16 included).
* :func:`tables_from_jax` — a reference ``ServingPlans.tables_for_model``
  dict -> the port's ``lut_tables`` (same structure, tensors on the
  device, backend ``"pallas"`` renamed ``"cuda"``), so both packages can
  compute with the same slabs;
* :func:`lutnn_params_from_jax` — a reference LUT-NN parameter tree
  (``{"layers": [{w1, b1, w2, b2}, ...]}``) -> a
  :class:`~repro_torch.lutnn.LUTNN`;
* :func:`train_state_from_jax` — a reference train state (``params``,
  ``opt`` with ``mu`` / ``nu`` / ``count``, ``step``, ``ef_error``) -> the
  port's (:mod:`repro_torch.train.state`);
  :func:`train_state_from_checkpoint` / :func:`train_state_to_checkpoint`
  — a reference ``train/checkpoint.py`` directory into a port train
  state, and back (the layout is the same: :mod:`repro_torch.train.
  checkpoint`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.lutnn.model import LUTNN, LUTNNConfig
from repro_torch.nn.transformer import params_class
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.state import state_for

_BACKENDS = {"pallas": "cuda", "gather": "gather"}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: same 16 bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _copy_named(who: str, module: torch.nn.Module, flat: dict) -> None:
    """Copy ``flat`` (dotted name -> numpy leaf) into ``module``'s
    parameters of the same names, shapes and dtypes, bit for bit."""
    _copy_into(who, dict(module.named_parameters()), flat)


def _copy_into(who: str, named: dict, flat: dict) -> None:
    """Copy ``flat`` (dotted name -> numpy leaf) into ``named`` (dotted
    name -> tensor) of the same names, shapes and dtypes, bit for bit."""
    if set(flat) != set(named):
        raise ValueError(
            f"{who}: parameter names differ — reference only "
            f"{sorted(set(flat) - set(named))}, port only "
            f"{sorted(set(named) - set(flat))}")
    with torch.no_grad():
        for name, leaf in flat.items():
            t = named[name]
            src = _tensor(leaf, t.device)
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(
                    f"{who}: {name} is {tuple(src.shape)} "
                    f"{src.dtype}, the port expects {tuple(t.shape)} "
                    f"{t.dtype}")
            t.copy_(src)


def _flatten(tree: dict, prefix: str = "") -> dict:
    """``{dotted name: leaf}`` of a nested dict."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def params_from_jax(tree: dict, cfg, device=None):
    """Copy a reference parameter tree (numpy leaves) into the port's
    parameter module for ``cfg``'s family."""
    params = params_class(cfg)(cfg, device)
    _copy_named("params_from_jax", params, _flatten(tree))
    return params


def lutnn_params_from_jax(params: dict, cfg: LUTNNConfig,
                          device=None) -> LUTNN:
    """Copy a reference LUT-NN parameter tree (numpy leaves) into a
    :class:`~repro_torch.lutnn.LUTNN` on ``device``."""
    model = LUTNN(cfg, resolve_device(device))
    flat = {f"layers.{l}.{k}": v for l, layer in enumerate(params["layers"])
            for k, v in layer.items()}
    _copy_named("lutnn_params_from_jax", model, flat)
    return model


def tables_from_jax(tables, device=None):
    """Convert a reference ``lut_tables`` dict (numpy leaves) to the
    port's form on ``device``."""
    dev = resolve_device(device)

    def conv(v, key=None):
        if isinstance(v, np.ndarray):
            return _tensor(v, dev)
        if isinstance(v, dict):
            return {k: conv(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        if key == "backend":
            return _BACKENDS[v]
        return v

    return conv(tables)


def train_state_from_jax(tree: dict, cfg, tcfg, device=None) -> dict:
    """Copy a reference train state (numpy leaves) into a port train
    state for ``cfg`` and ``tcfg``: parameters, moments, the counters and,
    under ``grad_compress``, the error-feedback buffers."""
    state = state_for(params_from_jax(tree["params"], cfg, device), tcfg)
    params = state["params"]
    names = [n for n, _ in params.named_parameters()]
    lists = [("mu", state["opt"]["mu"], tree["opt"]["mu"]),
             ("nu", state["opt"]["nu"], tree["opt"]["nu"])]
    if tcfg.grad_compress:
        lists.append(("ef_error", state["ef_error"], tree["ef_error"]))
    for key, tensors, sub in lists:
        _copy_into(f"train_state_from_jax ({key})",
                   dict(zip(names, tensors)), _flatten(sub))
    state["opt"]["count"] = int(tree["opt"]["count"])
    state["step"] = int(tree["step"])
    return state


def train_state_from_checkpoint(ckpt_dir: str, cfg, tcfg, step=None,
                                device=None):
    """A reference (or port) checkpoint directory restored into a fresh
    port train state for ``cfg`` and ``tcfg``.  Returns ``(state,
    step)``."""
    return restore_checkpoint(ckpt_dir,
                              state_for(params_class(cfg)(cfg, device), tcfg),
                              step)


def train_state_to_checkpoint(state: dict, ckpt_dir: str, step: int) -> str:
    """Write a port train state in the reference's checkpoint layout (its
    ``restore_checkpoint`` reads it into its own train state)."""
    return save_checkpoint(ckpt_dir, state, step)
