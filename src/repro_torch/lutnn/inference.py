"""Bit-exact table-network inference (the function the Verilog computes).

Counterpart of the reference's ``lutnn/inference.py``.
:func:`quantize_input`, :func:`pack_codes` and :func:`unpack_address` are
own numpy copies.  :func:`table_forward` runs the network of truth tables
layer by layer on the tables' device, each layer through
:func:`repro_torch.kernels.lutnn_layer` (kernel K7 on the card, its plain
version on the CPU); :func:`reconstruct_tables` rebuilds compressed tables
through K5 / K6.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import PlanArrays, lut_reconstruct, lutnn_layer
from repro_torch.kernels.lutnn_layer import pack_addresses

from .model import LUTNNConfig, device_tables, first_argmax

CHUNK = 32768   # samples a layer call of table_forward takes at most


def quantize_input(x: np.ndarray, bits: int) -> np.ndarray:
    """Float features in [0,1] -> integer codes on the 2^bits grid."""
    levels = (1 << bits) - 1
    return np.rint(np.clip(x, 0.0, 1.0) * levels).astype(np.int64)


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack parent codes (..., F) into L-LUT addresses (parent 0 = MSB)."""
    f = codes.shape[-1]
    addr = np.zeros(codes.shape[:-1], dtype=np.int64)
    for k in range(f):
        addr |= codes[..., k].astype(np.int64) << (bits * (f - 1 - k))
    return addr


def unpack_address(addr: np.ndarray, bits: int, fanin: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`: (...,) -> (..., F)."""
    mask = (1 << bits) - 1
    cols = [
        (addr >> (bits * (fanin - 1 - k))) & mask for k in range(fanin)
    ]
    return np.stack(cols, axis=-1)


def quantize_codes(x, bits: int, device) -> torch.Tensor:
    """:func:`quantize_input` on ``device``: float features -> int32 codes
    (the same float ops in the same dtype, so the same codes)."""
    levels = (1 << bits) - 1
    x = torch.as_tensor(x, device=device)
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels).to(torch.int32)


def table_forward(
    tables: list[torch.Tensor],
    conn: list[torch.Tensor],
    cfg: LUTNNConfig,
    x_codes: torch.Tensor,
    chunk: int = CHUNK,
    observers: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Evaluate the network of truth tables on the tables' device.

    ``tables[l]``: (n_l, 2^w_in_l) int32 output codes; ``conn[l]``:
    (n_l, F_l) int32 wiring; ``x_codes``: (B, n_inputs) integer input
    codes (beta0 bits) — all on one device (:func:`device_tables`).
    ``observers``: optional per-layer bool tensors (n_l, 2^w_in_l) on that
    device — every visited address is marked True (don't-care
    identification, paper SS4.1), with tensor ops, no host sync.
    Returns (B, n_classes) int32 output codes.
    """
    x_codes = x_codes.to(torch.int32)
    outs = []
    for s in range(0, x_codes.shape[0], chunk):
        h = x_codes[s:s + chunk]
        for l, table in enumerate(tables):
            bits = cfg.layer_beta_in(l)
            if observers is not None:
                addr = pack_addresses(h, conn[l], bits)          # (b, n_l)
                rows = torch.arange(table.shape[0], device=h.device)
                flat = rows * table.shape[1] + addr
                observers[l].view(-1).index_fill_(0, flat.view(-1), True)
            h = lutnn_layer(h, conn[l], table, bits=bits)        # (b, n_l)
        outs.append(h)
    return torch.cat(outs, dim=0)


def table_accuracy(
    tables: list[torch.Tensor],
    conn: list[torch.Tensor],
    cfg: LUTNNConfig,
    x: np.ndarray,
    y: np.ndarray,
) -> float:
    """Share of samples whose first-argmax output code is the label (ties
    to the first index, as ``np.argmax``), on the tables' device."""
    dev = tables[0].device
    codes = quantize_codes(x, cfg.beta0, dev)
    scores = table_forward(tables, conn, cfg, codes)
    hits = first_argmax(scores) == torch.as_tensor(y, device=dev)
    return int(hits.sum()) / len(y)


def reconstruct_tables(plans, cfg: LUTNNConfig, dev) -> list[torch.Tensor]:
    """Every plan's full table on ``dev`` (K5 / K6 at all ``2^w_in``
    addresses), regrouped per layer and checked against
    ``plan.reconstruct()``."""
    addrs = {}
    flat = []
    for plan in plans:
        if plan.w_in not in addrs:
            addrs[plan.w_in] = torch.arange(1 << plan.w_in,
                                            dtype=torch.int32, device=dev)
        flat.append(lut_reconstruct(addrs[plan.w_in],
                                    PlanArrays.from_plan(plan, device=dev)))
    tables, k = [], 0
    for l, n in enumerate(cfg.layer_sizes):
        t = torch.stack(flat[k:k + n])
        want = np.stack([p.reconstruct() for p in plans[k:k + n]])
        if not np.array_equal(t.cpu().numpy(), want):
            bad = int((t.cpu().numpy() != want).sum())
            raise AssertionError(
                f"layer {l}: {bad} reconstructed entries differ from "
                f"plan.reconstruct()")
        tables.append(t)
        k += n
    return tables
