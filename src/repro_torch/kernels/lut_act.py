"""LUT-approximated activation: kernels K1 (layer-indexed) and K2 (per plan).

Counterparts of the reference's ``kernels/lut_act.py``:

* K1 ``lut_act_stacked`` replaces ``lut_act_stacked_pallas`` — one layer's
  component slabs out of padded ``(L, n)`` stacks, with the per-layer
  scalars (``l``/``w_lb``/``w_hb``, ``y_lo``/``span``) read from the
  ``(L, 3)``/``(L, 2)`` meta tables in device memory, so the layer loop
  needs no host sync;
* K2 ``lut_act`` replaces ``lut_act_pallas`` — the same math with the
  per-plan scalars passed as kernel arguments (shared tables, unrolled
  execution).

Both run one CUDA kernel (``csrc/lut_act.cu``, device function in
``csrc/lut_eval.cuh``); each has its plain PyTorch version here, which the
CPU tests and the on-card comparison use.  The launch wrappers that pick
between the two by the input's device live in :mod:`.ops`.

Numerics contract (the reference's XLA lowering, measured bit for bit):

* quantize ``xn = clamp((x - f32(x_lo)) * f32(1/f32(x_hi - x_lo)), 0, 1)``
  and ``code = rint(xn * levels_in)`` with round half to even — XLA
  rewrites the division by the constant span into a multiply by its f32
  reciprocal;
* dequantize ``y = fma(f32(val), f32(f32(1/levels_out) * span), y_lo)``
  with ONE rounding — XLA folds the two scalings into one coefficient and
  contracts the multiply-add.

A NaN input maps to code 0 in both the kernel and the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .packing import COMPONENTS, unpack_take

# dtype codes of the C interface (csrc/lut_eval.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -------------------------------------------------------------------------
# host-rounded float32 constants (shared by the plain versions and kernels)
# -------------------------------------------------------------------------
def quant_constants(w_in: int, x_lo: float, x_hi: float):
    """``(f32(x_lo), f32(1/f32(x_hi - x_lo)), f32(2^w_in - 1))``."""
    return (np.float32(x_lo),
            np.float32(1.0) / np.float32(x_hi - x_lo),
            np.float32((1 << w_in) - 1))


def inv_levels_out(w_out: int) -> np.float32:
    return np.float32(1.0) / np.float32((1 << w_out) - 1)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``fma(a, b, c)`` on float32 tensors with one rounding, in plain ops.

    The product of two float32 values is exact in float64 (48 significant
    bits).  The float64 sum is made exact-or-odd: TwoSum gives its
    rounding error, and an inexact sum with an even last bit moves one
    ulp toward the exact value (round to odd).  Rounding a round-to-odd
    float64 to float32 is the correctly rounded float32 result, because
    float64 carries more than 24 + 2 bits — so the result equals a fused
    multiply-add, whatever the exponents of ``a * b`` and ``c``.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where(bump, torch.nextafter(s, toward), s)
    return s.float()


# -------------------------------------------------------------------------
# plain versions
# -------------------------------------------------------------------------
def _take(row: torch.Tensor, comp: str, idx: torch.Tensor,
          pack: dict | None) -> torch.Tensor:
    if not pack or comp not in pack:
        return row[idx.long()]
    p = pack[comp]
    return unpack_take(row, idx, width=p["width"], offset=p["offset"],
                       per_word=p["per_word"])


def lut_eval_plain(x, rows: dict, l, w_lb, w_hb, y_lo, span, *, any_lb,
                   w_in, w_out, x_lo, x_hi, pack=None) -> torch.Tensor:
    """Quantize -> Eq. (1) -> dequantize over one plan's component rows.

    ``l``/``w_lb``/``w_hb`` are ints or int32 0-d tensors (a layer's meta
    row); ``y_lo``/``span`` float32 0-d tensors.  ``t_lb`` is read only
    where the layer has ``w_lb > 0`` (index 0 elsewhere), so no index
    leaves its row."""
    dev = x.device
    x_lo32, inv_span32, levels_in32 = (
        torch.tensor(v, device=dev) for v in quant_constants(w_in, x_lo,
                                                              x_hi))
    xn = torch.clamp((x.float() - x_lo32) * inv_span32, 0.0, 1.0)
    xn = torch.nan_to_num(xn, nan=0.0)
    code = torch.round(xn * levels_in32).to(torch.int32)

    one = torch.ones((), dtype=torch.int32, device=dev)
    l, w_lb, w_hb = (torch.as_tensor(v, dtype=torch.int32, device=dev)
                     for v in (l, w_lb, w_hb))
    m = one << l
    c_hb = code >> l
    c_lb = code & (m - 1)
    idx = _take(rows["t_idx"], "t_idx", c_hb, pack)
    val = _take(rows["t_ust"], "t_ust", idx * m + c_lb, pack)
    val = val >> _take(rows["t_rsh"], "t_rsh", c_hb, pack)
    val = val + _take(rows["t_bias"], "t_bias", c_hb, pack)
    val = val & ((one << torch.clamp(w_hb, min=1)) - 1)
    if any_lb:
        has_lb = w_lb > 0
        lb = _take(rows["t_lb"], "t_lb",
                   torch.where(has_lb, code, torch.zeros_like(code)), pack)
        val = torch.where(has_lb, (val << w_lb) | lb, val)
    coef = torch.tensor(inv_levels_out(w_out), device=dev) * span
    y = fma_f32(val.float(), coef, y_lo)
    return y.to(x.dtype)


def lut_act_plain(x, arrays: dict, *, l, w_lb, w_hb, w_in, w_out, x_lo,
                  x_hi, y_lo, y_hi, pack=None) -> torch.Tensor:
    """Plain K2: one plan's (raw or packed) arrays, per-plan scalars; the
    dequant span is rounded f64 -> f32 on the host."""
    dev = x.device
    return lut_eval_plain(
        x, arrays, l, w_lb, w_hb,
        torch.tensor(np.float32(y_lo), device=dev),
        torch.tensor(np.float32(y_hi - y_lo), device=dev),
        any_lb=w_lb > 0, w_in=w_in, w_out=w_out, x_lo=x_lo, x_hi=x_hi,
        pack=pack)


def lut_act_stacked_plain(x, stacked: dict, layer: int) -> torch.Tensor:
    """Plain K1: layer ``layer`` of a stacked entry (raw or packed)."""
    meta = stacked["meta"]
    rows = {c: stacked["arrays"][c][layer] for c in COMPONENTS}
    mi = stacked["meta_i"][layer]
    mf = stacked["meta_f"][layer]
    return lut_eval_plain(
        x, rows, mi[0], mi[1], mi[2], mf[0], mf[1],
        any_lb=meta["any_lb"], w_in=meta["w_in"], w_out=meta["w_out"],
        x_lo=meta["x_lo"], x_hi=meta["x_hi"], pack=meta.get("pack"))


# -------------------------------------------------------------------------
# kernel launch (C interface of csrc/lut_eval.cuh)
# -------------------------------------------------------------------------
def lut_launch_args(rows: dict, pack: dict | None, *, any_lb, w_in, w_out,
                    x_lo, x_hi, meta_i=None, meta_f=None, l=0, w_lb=0,
                    w_hb=0, y_lo=0.0, y_hi=0.0):
    """``(ptrs, iparams, fparams)`` host arrays for one launch.

    ``rows`` are one layer's (or plan's) contiguous int32 component rows on
    the card.  With ``meta_i``/``meta_f`` (that layer's meta rows) the
    kernel reads the per-layer scalars from device memory; otherwise the
    per-plan scalars ride in ``iparams``/``fparams``, host-rounded to f32.
    """
    ptrs = np.zeros(7, np.int64)
    ip = np.zeros(24, np.int32)
    for c, comp in enumerate(COMPONENTS):
        row = rows[comp]
        if row.dtype != torch.int32 or not row.is_contiguous():
            raise ValueError(
                f"lut kernel: component {comp} must be a contiguous int32 "
                f"row, got {row.dtype} (contiguous={row.is_contiguous()})")
        p = (pack or {}).get(comp)
        width, offset, per_word = ((p["width"], p["offset"], p["per_word"])
                                   if p else (32, 0, 1))
        n_words = row.numel()
        if comp == "t_lb" and not any_lb:
            n_words = 0   # never read: skip staging it
        ptrs[c] = row.data_ptr()
        ip[c], ip[5 + c], ip[10 + c], ip[15 + c] = (
            n_words, width, offset, per_word)
    if meta_i is not None:
        if (meta_i.dtype != torch.int32 or meta_f.dtype != torch.float32
                or not (meta_i.is_contiguous() and meta_f.is_contiguous())):
            raise ValueError(
                "lut kernel: meta rows must be contiguous int32 [l, w_lb, "
                "w_hb] and float32 [y_lo, span]")
        ptrs[5], ptrs[6] = meta_i.data_ptr(), meta_f.data_ptr()
    ip[20:24] = (l, w_lb, w_hb, int(bool(any_lb)))
    x_lo32, inv_span32, levels_in32 = quant_constants(w_in, x_lo, x_hi)
    fp = np.array([x_lo32, inv_span32, levels_in32, inv_levels_out(w_out),
                   np.float32(y_lo), np.float32(y_hi - y_lo)], np.float32)
    return ptrs, ip, fp


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA kernel launch failed (cudaError {status})")


def launch_lut(fn, name: str, x: torch.Tensor, args) -> torch.Tensor:
    """Run K1/K2 (``fn`` is the bound C entry point) over ``x``."""
    ptrs, ip, fp = args
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), ctypes.c_longlong(x.numel()),
                DTYPE_CODES[x.dtype], ptrs.ctypes.data, ip.ctypes.data,
                fp.ctypes.data, ctypes.c_void_p(stream))
    check_status(name, status)
    return y
