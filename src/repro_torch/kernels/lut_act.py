"""LUT-approximated activation: kernels K1 (layer-indexed), K2 (per plan)
and K4 (multi-site).

Counterparts of the reference's ``kernels/lut_act.py``:

* K1 ``lut_act_stacked`` replaces ``lut_act_stacked_pallas`` — one layer's
  component slabs out of padded ``(L, n)`` stacks, with the per-layer
  scalars (``l``/``w_lb``/``w_hb``, ``y_lo``/``span``) read from the
  ``(L, 3)``/``(L, 2)`` meta tables in device memory, so the layer loop
  needs no host sync;
* K2 ``lut_act`` replaces ``lut_act_pallas`` — the same math with the
  per-plan scalars passed as kernel arguments (shared tables, unrolled
  execution);
* K4 ``lut_act_multi`` replaces ``lut_act_multisite_pallas`` — one launch
  over several sites' tensors against the ``(S, L, n)`` multi-site
  super-slab, through a launch record built with the entry
  (:class:`MultiLaunch`: the sites' K1 records in super-slab order) and a
  plan per segment counts (:func:`k4_plan`).

K1/K2 run ``csrc/lut_act.cu``, K4 ``csrc/lut_act_multi.cu``; all three
share the device function in ``csrc/lut_eval.cuh``.  Each has its plain
PyTorch version here, which the CPU tests and the on-card comparison use.
The launch wrappers that pick between the two by the input's device live
in :mod:`.ops`.

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
import functools

import numpy as np
import torch

from .abstract import is_abstract
from .packing import COMPONENTS, unpack_take

# dtype codes of the C interface (csrc/lut_eval.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -------------------------------------------------------------------------
# host-rounded float32 constants (shared by the plain versions and kernels)
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=256)   # pure; on every K2 launch's path
def quant_constants(w_in: int, x_lo: float, x_hi: float):
    """``(f32(x_lo), f32(1/f32(x_hi - x_lo)), f32(2^w_in - 1))``."""
    return (np.float32(x_lo),
            np.float32(1.0) / np.float32(x_hi - x_lo),
            np.float32((1 << w_in) - 1))


@functools.lru_cache(maxsize=64)
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


def _scalar(v, dtype: torch.dtype, dev) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``dev``: a tensor as it is, a host scalar
    (exact in ``dtype``) filled in on the device, with no copy from the
    host, so that the plain versions run inside a CUDA graph capture."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=dev)


def lut_eval_plain(x, rows: dict, l, w_lb, w_hb, y_lo, span, *, any_lb,
                   w_in, w_out, x_lo, x_hi, pack=None) -> torch.Tensor:
    """Quantize -> Eq. (1) -> dequantize over one plan's component rows.

    ``l``/``w_lb``/``w_hb`` are ints or int32 0-d tensors (a layer's meta
    row); ``y_lo``/``span`` float32 0-d tensors.  ``t_lb`` is read only
    where the layer has ``w_lb > 0`` (index 0 elsewhere), so no index
    leaves its row."""
    dev = x.device
    x_lo32, inv_span32, levels_in32 = (
        _scalar(v, torch.float32, dev)
        for v in quant_constants(w_in, x_lo, x_hi))
    xn = torch.clamp((x.float() - x_lo32) * inv_span32, 0.0, 1.0)
    xn = torch.nan_to_num(xn, nan=0.0)
    code = torch.round(xn * levels_in32).to(torch.int32)

    one = torch.ones((), dtype=torch.int32, device=dev)
    l, w_lb, w_hb = (_scalar(v, torch.int32, dev) for v in (l, w_lb, w_hb))
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
    coef = _scalar(inv_levels_out(w_out), torch.float32, dev) * span
    y = fma_f32(val.float(), coef, y_lo)
    return y.to(x.dtype)


def lut_act_plain(x, arrays: dict, *, l, w_lb, w_hb, w_in, w_out, x_lo,
                  x_hi, y_lo, y_hi, pack=None) -> torch.Tensor:
    """Plain K2: one plan's (raw or packed) arrays, per-plan scalars; the
    dequant span is rounded f64 -> f32 on the host."""
    dev = x.device
    return lut_eval_plain(
        x, arrays, l, w_lb, w_hb,
        _scalar(np.float32(y_lo), torch.float32, dev),
        _scalar(np.float32(y_hi - y_lo), torch.float32, dev),
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


def lut_act_multi_plain(xs: dict, entry: dict, layer: int) -> dict:
    """Plain K4: ``{site: y}`` for ``{site: x}`` against a multi-site
    ``entry`` (``MultiSiteSlabs.entry()``) at ``layer``.  Each site is the
    plain K1 on its slice of the super-slab: the slice's host-rounded
    constants (``x_lo``, ``1/x_span``, ``levels_in``, ``1/levels_out``) are
    the ones ``meta_f``/``meta_q`` hold, so the bits are the multi-site
    kernel's."""
    from repro_torch.serve.stacked import multi_site_stacked_entry

    return {site: lut_act_stacked_plain(
                x, multi_site_stacked_entry(entry, site), layer)
            for site, x in xs.items()}


# -------------------------------------------------------------------------
# kernel launch (C interface of csrc/lut_eval.cuh)
# -------------------------------------------------------------------------
def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(
            f"{name}: CUDA kernel launch failed (cudaError {status})")


# -------------------------------------------------------------------------
# K1 / K2 / K3: the launch record, and the launch of K1 / K2 (C interface
# of csrc/lut_act.cu)
# -------------------------------------------------------------------------
_I5 = ctypes.c_int * 5


class LutRecord(ctypes.Structure):
    """``LutRecord`` of ``csrc/lut_eval.cuh``, field for field."""

    _fields_ = [
        ("base", ctypes.c_longlong * 5), ("meta_i", ctypes.c_longlong),
        ("meta_f", ctypes.c_longlong), ("row_words", _I5),
        ("n_words", _I5), ("width", _I5), ("offset", _I5),
        ("per_word", _I5), ("div_mul", ctypes.c_uint * 5),
        ("div_shift", _I5), ("meta_i_ld", ctypes.c_int),
        ("meta_f_ld", ctypes.c_int), ("n_layers", ctypes.c_int),
        ("any_lb", ctypes.c_int), ("l", ctypes.c_int), ("w_lb", ctypes.c_int),
        ("w_hb", ctypes.c_int), ("x_lo", ctypes.c_float),
        ("x_inv_span", ctypes.c_float), ("levels_in", ctypes.c_float),
        ("inv_levels_out", ctypes.c_float), ("y_lo", ctypes.c_float),
        ("span", ctypes.c_float)]


@functools.lru_cache(maxsize=None)
def fast_divmod(d: int) -> tuple[int, int]:
    """``(mul, shift)`` with ``idx // d == (umulhi(idx, mul) + idx) >>
    shift`` for ``0 <= idx < 2^31`` and ``d`` in 1..32: the constants a
    launch record carries for ``csrc/lut_eval.cuh::take()``, which then
    divides by the codes per word without a division instruction."""
    if not 1 <= d <= 32:
        raise ValueError(f"fast_divmod: divisor {d} outside 1..32")
    shift = (d - 1).bit_length()   # ceil(log2 d)
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _unpack_params(comp: str, pack: dict | None) -> tuple[int, int, int]:
    p = (pack or {}).get(comp)
    return (p["width"], p["offset"], p["per_word"]) if p else (32, 0, 1)


class LutLaunch:
    """A K1 / K2 / K3 launch record on one device: the C struct, the layer
    count, the card's SM count (0 off the card), and the tensors the
    record points at — held, so that the record never outlives them.
    The table entries carry theirs, built with the entry
    (``StackedPlanArrays.entry``, ``MultiSiteSlabs.entry``,
    ``SitePlan.entry``).  Inside :func:`.abstract.abstract` (tensors
    without data, no pointers) ``rec`` is ``None``: the record keeps its
    device, layer count and tensors only.  ``layer_bytes``: the table
    bytes one launch reads, one row of each tensor."""

    def __init__(self, rec: LutRecord | None, device: torch.device, tensors,
                 n_layers: int | None = None):
        self.rec = rec
        self.addr = 0 if rec is None else ctypes.addressof(rec)
        self.device = device
        self.n_layers = rec.n_layers if rec is not None else n_layers
        self.tensors = tuple(tensors)
        self.layer_bytes = sum(t.shape[-1] * t.element_size()
                               for t in self.tensors)
        self.sm_count = (sm_count(device) if device.type == "cuda"
                         and rec is not None else 0)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _record(rows: list, pack, *, any_lb, w_in, w_out, x_lo, x_hi,
            row_words=(0,) * 5, meta=(None, None), n_layers=1, l=0, w_lb=0,
            w_hb=0, y_lo=0.0, span=0.0) -> LutRecord:
    """A ``LutRecord`` for the five components' tensors ``rows`` (a
    stack's ``(L, W)`` or one plan's row, in :data:`COMPONENTS` order)
    and the meta tables ``meta`` (``(None, None)`` for one plan)."""
    params = [_unpack_params(c, pack) for c in COMPONENTS]
    divs = [fast_divmod(p[2]) for p in params]
    mi, mf = meta
    x_lo32, inv_span32, levels_in32 = quant_constants(w_in, x_lo, x_hi)
    return LutRecord(
        base=tuple(t.data_ptr() for t in rows),
        meta_i=0 if mi is None else mi.data_ptr(),
        meta_f=0 if mf is None else mf.data_ptr(),
        row_words=tuple(row_words),
        n_words=tuple(0 if c == "t_lb" and not any_lb else t.shape[-1]
                      for c, t in zip(COMPONENTS, rows)),
        width=tuple(p[0] for p in params),
        offset=tuple(p[1] for p in params),
        per_word=tuple(p[2] for p in params),
        div_mul=tuple(d[0] for d in divs),
        div_shift=tuple(d[1] for d in divs),
        meta_i_ld=0 if mi is None else mi.stride(0),
        meta_f_ld=0 if mf is None else mf.stride(0),
        n_layers=n_layers, any_lb=int(bool(any_lb)), l=l, w_lb=w_lb,
        w_hb=w_hb, x_lo=x_lo32, x_inv_span=inv_span32,
        levels_in=levels_in32, inv_levels_out=inv_levels_out(w_out),
        y_lo=np.float32(y_lo), span=np.float32(span))


def _check_record_tensors(name: str, tensors: list, device) -> None:
    for t in tensors:
        if t.device != device or t.stride(-1) != 1:
            raise ValueError(
                f"{name}: every table tensor must lie on {device} with "
                f"contiguous rows; got {tuple(t.shape)} on {t.device}, "
                f"strides {t.stride()}")


def stacked_record(stacked: dict) -> LutLaunch:
    """K1's record of a stacked entry (``StackedPlanArrays.entry()`` or a
    site's slice of the multi-site super-slab), validated once: the five
    ``(L, W_c)`` int32 stacks and the ``(L, 3)`` / ``(L, 2)`` meta tables
    on one card, each with contiguous rows."""
    meta = stacked["meta"]
    stacks = [stacked["arrays"][c] for c in COMPONENTS]
    mi, mf = stacked["meta_i"], stacked["meta_f"]
    n_layers = mi.shape[0]
    for t in stacks:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != n_layers:
            raise ValueError(f"lut_act_stacked: component stack "
                             f"{tuple(t.shape)} {t.dtype} is not an "
                             f"({n_layers}, W) int32 stack")
    if (mi.dtype != torch.int32 or mf.dtype != torch.float32
            or mi.dim() != 2 or mf.dim() != 2 or mi.shape[1] < 3
            or mf.shape[1] < 2 or mf.shape[0] != n_layers):
        raise ValueError("lut_act_stacked: meta tables must be (L, 3) int32 "
                         "[l, w_lb, w_hb] and (L, 2) float32 [y_lo, span]")
    _check_record_tensors("lut_act_stacked", stacks + [mi, mf], mi.device)
    if is_abstract():
        return LutLaunch(None, mi.device, stacks + [mi, mf], n_layers)
    rec = _record(stacks, meta.get("pack"), any_lb=meta["any_lb"],
                  w_in=meta["w_in"], w_out=meta["w_out"], x_lo=meta["x_lo"],
                  x_hi=meta["x_hi"],
                  row_words=[t.stride(0) for t in stacks], meta=(mi, mf),
                  n_layers=n_layers)
    return LutLaunch(rec, mi.device, stacks + [mi, mf])


def plan_record(arrays: dict, pack: dict | None, *, l, w_lb, w_hb, w_in,
                w_out, x_lo, x_hi, y_lo, y_hi) -> LutLaunch:
    """K2's record of one plan: its five int32 rows on one card, the
    per-plan scalars in the record (host-rounded to f32), row strides 0."""
    rows = [arrays[c] for c in COMPONENTS]
    for t in rows:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"lut_act: component row {tuple(t.shape)} "
                             f"{t.dtype} is not a 1-D int32 row")
    _check_record_tensors("lut_act", rows, rows[0].device)
    if is_abstract():
        return LutLaunch(None, rows[0].device, rows, 1)
    rec = _record(rows, pack, any_lb=w_lb > 0, w_in=w_in, w_out=w_out,
                  x_lo=x_lo, x_hi=x_hi, l=l, w_lb=w_lb, w_hb=w_hb,
                  y_lo=y_lo, span=y_hi - y_lo)
    return LutLaunch(rec, rows[0].device, rows)


def entry_plan_record(entry: dict) -> LutLaunch:
    """K2's record of a per-plan site entry ``{"meta", "arrays"}``."""
    m = entry["meta"]
    return plan_record(entry["arrays"], m.get("pack"), l=m["l"],
                       w_lb=m["w_lb"], w_hb=m["w_hb"], w_in=m["w_in"],
                       w_out=m["w_out"], x_lo=m["x_lo"], x_hi=m["x_hi"],
                       y_lo=m["y_lo"], y_hi=m["y_hi"])


# threads per block
K1_THREADS = 128
K1_BLOCKS_PER_SM = 2048 // K1_THREADS


def k1_units(cols: int, head: int, vec: int) -> int:
    """Work units of one row: its whole ``vec``-element vectors after
    ``head`` leading elements, then the head and tail elements one each."""
    nv = (cols - head) // vec
    return nv + cols - nv * vec


@functools.lru_cache(maxsize=1024)   # pure: one plan per shape, cached
def k1_plan(rows: int, cols: int, dtype: torch.dtype, *, sm_count: int,
            aligned: bool = True) -> tuple[int, int, int, int]:
    """``(threads, grid_x, grid_y, vec)`` of a K1 / K2 launch over a
    ``(rows, cols)`` view.  ``vec``: elements a thread loads and stores at
    once — 16 bytes where that still gives every SM a block (prefill),
    else 1, so that a decode step's few thousand elements spread over the
    SMs instead of a dozen blocks.  ``grid_x`` blocks over a row's units
    (one unit a thread where the card holds them all at once), ``grid_y``
    over the rows, together at most a full card of resident blocks; each
    dimension strides over what it does not cover.  ``aligned``: every row
    starts on a 16-byte boundary (else the plan allows for the worst
    head)."""
    vec = 16 // dtype.itemsize
    units = k1_units(cols, 0, vec) if aligned else max(
        k1_units(cols, min(h, cols), vec) for h in range(vec))
    if rows * units < sm_count * K1_THREADS:
        vec, units = 1, cols
    cap = max(1, sm_count) * K1_BLOCKS_PER_SM
    grid_x = min(max(1, -(-units // K1_THREADS)), cap)
    grid_y = min(max(1, rows), max(1, cap // grid_x), 65535)
    return K1_THREADS, grid_x, grid_y, vec


def k1_view(x: torch.Tensor) -> tuple[int, int, int]:
    """``(rows, cols, ld)`` of ``x`` read in place: a contiguous tensor as
    one row of all its elements, else a ``(rows, cols)`` view with unit
    column stride and row stride ``ld`` where the leading dimensions
    collapse into one (the ``gate`` half of a ``[gate|up]`` product does);
    ``None`` where they do not."""
    if x.is_contiguous():
        return 1, x.numel(), x.numel()
    cols = x.shape[-1]
    lead = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    if x.stride(-1) != 1 and cols != 1:
        return None
    if not lead:
        return 1, cols, cols
    if any(s != s2 * n2 for (_, s), (n2, s2) in zip(lead, lead[1:])):
        return None
    return x.numel() // cols, cols, lead[-1][1]


def launch_lut(fn, name: str, x: torch.Tensor, rec: LutLaunch,
               layer: int) -> torch.Tensor:
    """Run K1 / K2 (``fn`` is the bound C entry point) over ``x`` (any
    shape and strides on the record's card) at ``layer``; the output is
    contiguous, of ``x``'s shape.  ``fn`` ``None`` (the abstract route)
    validates, reads ``x`` as the kernel would and returns the empty
    output without a launch."""
    if x.device != rec.device:
        raise ValueError(f"{name}: input on {x.device}, tables on "
                         f"{rec.device} — the kernel runs on the tables' "
                         f"card and the plain version on the CPU")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(
            f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not 0 <= layer < rec.n_layers:
        raise ValueError(f"{name}: layer {layer} outside the record's "
                         f"{rec.n_layers} layers")
    view = k1_view(x)
    if view is None:   # leading dimensions that do not collapse: copy
        x = x.contiguous()
        view = k1_view(x)
    rows, cols, ld = view
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if fn is None:
        return y
    ptr = x.data_ptr()
    aligned = ptr % 16 == 0 and (rows == 1 or ld * x.element_size() % 16
                                 == 0)
    plan = k1_plan(rows, cols, x.dtype, sm_count=rec.sm_count,
                   aligned=aligned)
    # the raw handle of PyTorch's current stream, without building a
    # torch.cuda.Stream object per launch
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    check_status(name, fn(rec.addr, layer, ptr, y.data_ptr(), rows, cols,
                          ld, code, *plan, stream))
    return y


# -------------------------------------------------------------------------
# K4: the launch record of a multi-site entry, the plan and the per-call
# arguments (C interface of csrc/lut_act_multi.cu)
# -------------------------------------------------------------------------
MAX_SEGMENTS = 8    # segments per launch (kMaxSegs)
K4_THREADS = 128    # threads per block at most (kMaxThreads)


class K4Segment(ctypes.Structure):
    """``Segment`` of ``csrc/lut_act_multi.cu``, field for field."""

    _fields_ = [("x", ctypes.c_longlong), ("y", ctypes.c_longlong),
                ("n", ctypes.c_longlong), ("site", ctypes.c_int),
                ("block0", ctypes.c_int), ("blocks", ctypes.c_int)]


class MultiLaunch:
    """K4's launch record of a multi-site entry, built from its sites' K1
    records (``{site: LutLaunch}``, each over its slice of the super-slab)
    in the order ``sites``: copied into one contiguous ``LutRecord`` array,
    whose address and length the C entries take, and held themselves, so
    that the array never outlives the tensors it points at."""

    def __init__(self, site_records: dict, sites):
        self.site_ids = {s: i for i, s in enumerate(sites)}
        self.records = tuple(site_records[s] for s in sites)
        first = self.records[0]
        for r in self.records:
            if r.device != first.device or r.n_layers != first.n_layers:
                raise ValueError(
                    "lut_act_multi: the sites' records disagree on the "
                    "device or the layer count")
        if first.rec is None:   # the abstract route's records
            self.recs, self.addr = tuple(self.records), 0
        else:
            self.recs = (LutRecord * len(sites))(
                *(r.rec for r in self.records))
            self.addr = ctypes.addressof(self.recs)
        self.device, self.sm_count = first.device, first.sm_count
        self.n_layers = first.n_layers


@functools.lru_cache(maxsize=1024)   # pure: one plan per segment counts
def k4_plan(counts: tuple, dtype: torch.dtype, *, sm_count: int
            ) -> tuple[int, int, tuple]:
    """``(threads, vec, blocks)`` of a K4 launch over segments of
    ``counts`` elements.  ``vec``: elements a thread loads and stores at
    once — 16 bytes where the launch's units still fill the card's SMs
    with full blocks (prefill), else 1, with blocks of 32 to 128 threads
    so that a decode launch (5120 attention scores) gives every SM a
    block.  ``blocks``: each segment's blocks, one unit a thread (a
    segment's units counted for the worst 16-byte misalignment of its
    start), capped at a full card of resident threads; the kernel strides
    over what a segment's blocks do not cover."""
    vec = 16 // dtype.itemsize
    units = [max(k1_units(n, min(h, n), vec) for h in range(vec))
             for n in counts]
    threads = K4_THREADS
    if sum(units) < sm_count * K4_THREADS:
        vec, units = 1, list(counts)
        threads = min(K4_THREADS, max(32, sum(counts) // sm_count // 32 * 32))
    cap = max(1, sm_count) * (2048 // threads)
    return threads, vec, tuple(min(max(1, -(-u // threads)), cap)
                               for u in units)


def k4_call(xs: dict, rec: MultiLaunch, layer: int):
    """The per-call half of a K4 launch over ``{site: x}`` (each on the
    record's card, all of one dtype) at ``layer``: ``(out, call)`` with
    ``out`` the outputs ``{site: y}`` (contiguous, of ``x``'s shape) and
    ``call`` the C entry point's name, its arguments up to the stream, and
    the inputs they point at (held until the launch), or ``None`` when
    every input is empty.  One segment (every served call) goes by scalar
    arguments; several by a segment table made for the call."""
    if not 0 <= layer < rec.n_layers:
        raise ValueError(f"lut_act_multi: layer {layer} outside the "
                         f"super-slab's {rec.n_layers} layers")
    dtypes = {x.dtype for x in xs.values()}
    if len(dtypes) != 1:
        raise ValueError(f"lut_act_multi: one launch takes one dtype, got "
                         f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise ValueError(
            f"lut_act_multi: dtype {dtype} not supported (float32, bfloat16)")
    out, segs = {}, []
    for site, x in xs.items():
        sid = rec.site_ids[site]
        if x.device != rec.device:
            raise ValueError(f"lut_act_multi: input on {x.device}, tables on "
                             f"{rec.device}")
        x = x.contiguous()
        out[site] = y = torch.empty(x.shape, dtype=dtype, device=x.device)
        if x.numel():
            segs.append((x, y, sid))
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"lut_act_multi: {len(segs)} segments; a launch "
                         f"takes 1 to {MAX_SEGMENTS}")
    if not segs:
        return out, None
    held = tuple(x for x, _, _ in segs)
    if is_abstract():
        return out, ("abstract", (), held)
    threads, vec, blocks = k4_plan(tuple(x.numel() for x, _, _ in segs),
                                   dtype, sm_count=rec.sm_count)
    if len(segs) == 1:
        (x, y, sid), = segs
        return out, ("rlut_lut_act_multi",
                     (rec.addr, len(rec.recs), layer, x.data_ptr(),
                      y.data_ptr(), x.numel(), sid, code, threads, blocks[0],
                      vec), held)
    table = (K4Segment * len(segs))(*(
        K4Segment(x.data_ptr(), y.data_ptr(), x.numel(), sid, 0, b)
        for (x, y, sid), b in zip(segs, blocks)))
    return out, ("rlut_lut_act_multi_segs",
                 (rec.addr, len(rec.recs), layer, ctypes.addressof(table),
                  len(segs), code, threads, vec), held + (table,))


def launch_multi(call, rec: MultiLaunch) -> None:
    """Launch K4 on PyTorch's current stream: ``call`` from
    :func:`k4_call`."""
    from . import build

    name, args, _ = call
    stream = torch._C._cuda_getCurrentRawStream(rec.device.index)
    check_status("lut_act_multi", build.entry(name)(*args, stream))
