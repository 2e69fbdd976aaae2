"""Eq. (1) reconstruction at integer addresses (K5) and plain table lookup
(K6), with their plain versions.

Counterparts of the reference's ``kernels/lut_gather.py``:

* K5 ``lut_reconstruct`` replaces ``lut_reconstruct_pallas``:
  ``((t_ust[t_idx[x_hb] * M + x_lb] >> t_rsh[x_hb]) + t_bias[x_hb]) & mask``
  with ``mask = 2^max(w_hb, 1) - 1``, then ``(· << w_lb) | t_lb[x]`` when
  ``w_lb > 0``;
* K6 ``plain_lookup`` replaces ``plain_lookup_pallas``: ``table[x]``.

Both kernels live in ``csrc/lut_gather.cu``.  They take the flat address
count and mask the tail, so the addresses need no ``(rows, 128)`` pad
copy.  Neither stages its tables: both read them through the read-only
cache and move addresses and outputs 16 bytes at a time where both
pointers are 16-byte aligned (scalar accesses otherwise).  The launch
wrappers that pick between kernel and plain version by the input's device
live in :mod:`.ops`.
"""
from __future__ import annotations

import torch

from .lut_act import check_status
from .packing import COMPONENTS


# -------------------------------------------------------------------------
# plain versions
# -------------------------------------------------------------------------
def lut_reconstruct_plain(x, t_ust, t_idx, t_rsh, t_bias, t_lb, *, l: int,
                          w_lb: int, w_hb: int) -> torch.Tensor:
    """Plain K5: Eq. (1) at int32 addresses ``x`` (any shape)."""
    x = x.to(torch.int32)
    m = 1 << l
    x_hb = (x >> l).long()
    x_lb = x & (m - 1)
    idx = t_idx[x_hb]
    val = t_ust[(idx * m + x_lb).long()] >> t_rsh[x_hb]
    val = (val + t_bias[x_hb]) & ((1 << max(w_hb, 1)) - 1)
    if w_lb > 0:
        val = (val << w_lb) | t_lb[x.long()]
    return val


def plain_lookup_plain(x, table) -> torch.Tensor:
    """Plain K6: ``table[x]`` at int32 addresses ``x`` (any shape)."""
    return table[x.long()]


# -------------------------------------------------------------------------
# kernel launches (C interface of csrc/lut_gather.cu)
# -------------------------------------------------------------------------
def _stream(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``x``'s card, without
    building a ``torch.cuda.Stream`` object per launch."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def lut_reconstruct_cuda(x: torch.Tensor, arrays: dict, *, l: int,
                         w_lb: int, w_hb: int) -> torch.Tensor:
    """Launch K5 on a contiguous int32 ``x`` on the card; ``arrays`` are
    the plan's contiguous int32 component arrays on the same card."""
    from . import build

    out = torch.empty_like(x)
    args = []
    for comp in COMPONENTS:
        t = arrays[comp]
        # t_lb is never read on a w_lb == 0 plan: pass no entries
        n = 0 if comp == "t_lb" and w_lb == 0 else t.numel()
        args += [t.data_ptr(), n]
    check_status("lut_reconstruct", build.entry("rlut_lut_reconstruct")(
        x.data_ptr(), out.data_ptr(), x.numel(), *args, l, w_lb, w_hb,
        _stream(x)))
    return out


def plain_lookup_cuda(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch K6 on a contiguous int32 ``x`` on the card."""
    from . import build

    out = torch.empty_like(x)
    check_status("plain_lookup", build.entry("rlut_plain_lookup")(
        x.data_ptr(), out.data_ptr(), x.numel(), table.data_ptr(),
        table.numel(), _stream(x)))
    return out

