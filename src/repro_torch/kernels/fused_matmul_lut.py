"""Matmul-epilogue LUT fusion: kernel K3 and its plain version.

Counterpart of the reference's ``kernels/fused_matmul_lut.py``
(``fused_matmul_lut_pallas``): ``act(x @ w)``, or ``act(gate) * up`` over
a fused ``[gate|up]`` weight, with the LUT activation applied while the
GEMM output tile is still on chip (``csrc/fused_matmul_lut.cu``).

The GEMM accumulates in f32 and is rounded to the model dtype before the
quantizer, as in the reference; the gated product is rounded to the model
dtype once more.  The kernel's own accumulation order (k ascending) is not
cuBLAS's, so the kernel is held bit for bit against its own GEMM
(``epilogue=False``) followed by K1, and against the plain version by the
share of outputs that differ (a bin flip where a GEMM output sits at a
quantizer edge).  On inputs whose every partial sum is exact the plain
version is bit-exact against the reference.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .lut_act import (
    DTYPE_CODES,
    check_status,
    lut_act_plain,
    lut_act_stacked_plain,
    lut_launch_args,
)
from .packing import COMPONENTS


def stacked_parts(tab: dict):
    """Normalize a resolved site entry to ``(arrays, meta_i, meta_f, layer,
    statics)`` (reference: ``_as_stacked_parts``).

    Three entry shapes arrive here: the stacked per-layer form, the
    multi-site marker (statically sliced out of the shared super-slab) and
    the shared/unrolled per-plan form — the last as a one-layer stack at
    layer 0 with ``meta_i``/``meta_f`` ``None``: its scalars ride in
    ``statics`` and reach the kernel as arguments."""
    if "multi_entry" in tab:
        from repro_torch.serve.stacked import multi_site_stacked_entry

        st = multi_site_stacked_entry(tab["multi_entry"], tab["site"])
        return (st["arrays"], st["meta_i"], st["meta_f"], tab["layer"],
                st["meta"])
    if "stacked" in tab:
        st = tab["stacked"]
        return (st["arrays"], st["meta_i"], st["meta_f"], tab["layer"],
                st["meta"])
    meta, arrays = tab["meta"], tab["arrays"]
    statics = dict(meta, any_lb=meta["w_lb"] > 0)
    return {c: a[None] for c, a in arrays.items()}, None, None, 0, statics


def _lut_plain(h, parts):
    arrays, meta_i, meta_f, layer, st = parts
    if meta_i is not None:
        return lut_act_stacked_plain(
            h, {"meta": st, "arrays": arrays, "meta_i": meta_i,
                "meta_f": meta_f}, layer)
    return lut_act_plain(
        h, {c: a[0] for c, a in arrays.items()}, l=st["l"],
        w_lb=st["w_lb"], w_hb=st["w_hb"], w_in=st["w_in"],
        w_out=st["w_out"], x_lo=st["x_lo"], x_hi=st["x_hi"],
        y_lo=st["y_lo"], y_hi=st["y_hi"], pack=st.get("pack"))


def fused_matmul_lut_plain(x2d, w, tab, *, gated: bool,
                           epilogue: bool = True) -> torch.Tensor:
    """Plain K3 on ``(M, K) @ (K, N)``: ``torch.matmul`` in the model dtype
    (one rounding of the f32 accumulation), then the plain LUT."""
    h = torch.matmul(x2d, w)
    if not epilogue:
        return h
    parts = stacked_parts(tab)
    if gated:
        gate, up = h.chunk(2, dim=-1)
        return _lut_plain(gate, parts) * up
    return _lut_plain(h, parts)


def fused_matmul_lut_cuda(x2d, w, tab, *, gated: bool,
                          epilogue: bool = True) -> torch.Tensor:
    """Launch K3 on card tensors (the wrapper in :mod:`.ops` validates)."""
    from . import build

    m, k = x2d.shape
    n = w.shape[1]
    f = n // 2 if gated else n
    if epilogue:
        arrays, meta_i, meta_f, layer, st = stacked_parts(tab)
        rows = {c: arrays[c][layer] for c in COMPONENTS}
        scal = {} if meta_i is not None else dict(
            l=st["l"], w_lb=st["w_lb"], w_hb=st["w_hb"], y_lo=st["y_lo"],
            y_hi=st["y_hi"])
        ptrs, ip, fp = lut_launch_args(
            rows, st.get("pack"), any_lb=st["any_lb"], w_in=st["w_in"],
            w_out=st["w_out"], x_lo=st["x_lo"], x_hi=st["x_hi"],
            meta_i=None if meta_i is None else meta_i[layer],
            meta_f=None if meta_f is None else meta_f[layer], **scal)
        out = torch.empty((m, f), dtype=x2d.dtype, device=x2d.device)
    else:
        ptrs = np.zeros(7, np.int64)
        ip = np.zeros(24, np.int32)
        ip[5:10] = 32
        ip[15:20] = 1
        fp = np.zeros(6, np.float32)
        out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    status = build.entry("rlut_fused_matmul_lut")(
        x2d.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, int(gated),
        int(epilogue), DTYPE_CODES[x2d.dtype], ptrs.ctypes.data,
        ip.ctypes.data, fp.ctypes.data, ctypes.c_void_p(stream))
    check_status("fused_matmul_lut", status)
    return out
