"""One layer of a LUT network (K7), with its plain version.

Counterpart of the reference's ``kernels/lutnn_layer.py``: K7
``lutnn_layer`` replaces ``lutnn_layer_pallas``.  For parent codes
``codes (B, P)``, wiring ``conn (N, F)`` and truth tables ``tables (N, T)``
(all int32), output ``out[b, n] = tables[n, addr]`` with
``addr = sum_k codes[b, conn[n, k]] << bits * (F - 1 - k)`` (parent 0 is
the most significant).  The kernel is ``csrc/lutnn_layer.cu``; the launch
wrapper lives in :mod:`.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from .lut_act import check_status

MAX_ADDR_BITS = 24   # bits * F; the paper's models need at most 14


def pack_addresses(codes: torch.Tensor, conn: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """The (B, N) int64 table addresses of one layer (parent 0 = MSB)."""
    f = conn.shape[1]
    gathered = codes[:, conn.long()].long()        # (B, N, F)
    addr = torch.zeros(gathered.shape[:-1], dtype=torch.int64,
                       device=codes.device)
    for k in range(f):
        addr |= gathered[..., k] << (bits * (f - 1 - k))
    return addr


def lutnn_layer_plain(codes: torch.Tensor, conn: torch.Tensor,
                      tables: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Plain K7: (B, N) int32 output codes."""
    addr = pack_addresses(codes, conn, bits)
    return torch.gather(tables, 1, addr.T).T.contiguous().to(torch.int32)


def lutnn_layer_cuda(codes: torch.Tensor, conn: torch.Tensor,
                     tables: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Launch K7 on contiguous int32 tensors on one card."""
    from . import build

    b, p = codes.shape
    n, f = conn.shape
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    check_status("lutnn_layer", build.entry("rlut_lutnn_layer")(
        codes.data_ptr(), conn.data_ptr(), tables.data_ptr(),
        out.data_ptr(), b, p, n, f, tables.shape[1], bits,
        ctypes.c_void_p(torch.cuda.current_stream(codes.device).cuda_stream)))
    return out
