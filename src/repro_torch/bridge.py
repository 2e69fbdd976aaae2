"""Carry the reference package's artifacts into the port, bit for bit.

The inputs are plain numpy trees — ``jax.tree.map(np.asarray, tree)`` on
the reference side — so this module imports nothing of JAX.

* :func:`params_from_jax` — a reference parameter tree (dense decoder)
  -> :class:`~repro_torch.nn.DecoderParams`; names and stacked layouts are
  the same, so every leaf is copied without renaming (bf16 included).
* :func:`tables_from_jax` — a reference ``ServingPlans.tables_for_model``
  dict -> the port's ``lut_tables`` (same structure, tensors on the
  device, backend ``"pallas"`` renamed ``"cuda"``), so both packages can
  compute with the same slabs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.transformer import DecoderParams

_BACKENDS = {"pallas": "cuda", "gather": "gather"}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16: same 16 bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree: dict, cfg, device=None) -> DecoderParams:
    """Copy a reference parameter tree (numpy leaves) into the port."""
    params = DecoderParams(cfg, device)
    named = dict(params.named_parameters())
    flat = {k: v for k, v in tree.items() if k != "blocks"}
    flat.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    if set(flat) != set(named):
        raise ValueError(
            f"params_from_jax: parameter names differ — reference only "
            f"{sorted(set(flat) - set(named))}, port only "
            f"{sorted(set(named) - set(flat))}")
    with torch.no_grad():
        for name, leaf in flat.items():
            t = named[name]
            src = _tensor(leaf, t.device)
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(
                    f"params_from_jax: {name} is {tuple(src.shape)} "
                    f"{src.dtype}, the port expects {tuple(t.shape)} "
                    f"{t.dtype}")
            t.copy_(src)
    return params


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
