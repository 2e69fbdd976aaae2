"""Plan slabs and the launch wrappers of the LUT kernels.

Counterpart of the reference's ``kernels/ops.py``:

* :class:`PlanArrays` — one plan's lane-padded component arrays, padded
  to 128 entries exactly as the reference pads them, so the slabs (raw or
  bit-packed) are byte-identical across the two packages;
* :func:`lut_act` (K2), :func:`lut_act_stacked` (K1),
  :func:`fused_matmul_lut` (K3), :func:`lut_act_multi` (K4),
  :func:`lut_reconstruct` (K5, or K6 through :func:`plain_lookup` for a
  plain plan), :func:`lutnn_layer` (K7), :func:`wkv` (K8) and
  :func:`wkv_backward` (K8b, its backward, through which :func:`wkv` is
  differentiable) — the launch wrappers.  A tensor on the CPU goes to the
  kernel's plain version; a tensor on the card goes to the kernel, or the
  wrapper raises.  Each wrapper counts its kernel launches in a plain integer
  attribute (``lut_act_stacked.launches``), so a run can show that it went
  through the kernels.

The LUT wrappers are the serving control plane's kernel fault points
(:func:`fault_hook`), and every launch is a telemetry point
(:func:`note_launch`: ``kernel_launches_total{backend="cuda"}``) and a
cost point of the roofline's counter (:mod:`repro_torch.roofline.costs`:
the bytes the kernel reads and writes, K3's product's operations).
Inside :func:`abstract` (a dry run on tensors without data) each wrapper
validates, tells the counter and returns an empty result without a launch
(:mod:`.abstract`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.core.plan import DecomposedPlan, Plan, PlainPlan
from repro_torch.device import resolve_device

from .abstract import abstract, check_data, is_abstract, on_card
from .fused_matmul_lut import (
    fused_matmul_lut_cuda,
    fused_matmul_lut_plain,
    lut_record,
)
from .lut_act import (
    DTYPE_CODES,
    k4_call,
    launch_lut,
    launch_multi,
    lut_act_multi_plain,
    lut_act_plain,
    lut_act_stacked_plain,
    plan_record,
)
from .lut_gather import (
    lut_reconstruct_cuda,
    lut_reconstruct_plain,
    plain_lookup_cuda,
    plain_lookup_plain,
)
from .lutnn_layer import (
    MAX_ADDR_BITS,
    lutnn_layer_cuda,
    lutnn_layer_plain,
)
from .packing import COMPONENTS, pack_component_dict
from .wkv import (
    wkv_backward_cuda,
    wkv_backward_plain,
    wkv_chunked_plain,
    wkv_cuda,
)

LANES = 128


def _pad_to(a: np.ndarray, mult: int) -> np.ndarray:
    n = a.shape[0]
    pad = (-n) % mult
    if pad:
        a = np.concatenate([a, np.zeros(pad, a.dtype)])
    return a


@dataclasses.dataclass
class PlanArrays:
    """Device-ready, lane-padded arrays for one compression plan: the
    five Eq. (1) components of a decomposed plan, or ``{"table": ...}``
    for a plain plan.

    ``pack`` (component -> unpack meta, :mod:`.packing`) marks the arrays
    as bit-packed int32 words; ``None`` means raw int32 (the gather
    backend's form)."""

    kind: str
    w_in: int
    w_out: int
    l: int = 0
    w_lb: int = 0
    w_hb: int = 0
    arrays: dict = dataclasses.field(default_factory=dict)
    pack: dict | None = None

    @staticmethod
    def host_arrays(plan: Plan, packed: bool = False
                    ) -> tuple[dict, dict | None]:
        """The padded (and optionally packed) numpy component arrays."""
        if isinstance(plan, PlainPlan):
            if packed:
                raise ValueError("PlanArrays: a plain plan has no packed "
                                 "form (its table is raw int32)")
            return {"table": _pad_to(plan.values.astype(np.int32),
                                     LANES)}, None
        lb = plan.t_lb if plan.t_lb is not None else np.zeros(1, np.int64)
        host = {
            "t_ust": _pad_to(plan.t_ust.astype(np.int32), LANES),
            "t_idx": _pad_to(plan.t_idx.astype(np.int32), LANES),
            "t_rsh": _pad_to(plan.t_rsh.astype(np.int32), LANES),
            "t_bias": _pad_to(plan.t_bias.astype(np.int32), LANES),
            "t_lb": _pad_to(lb.astype(np.int32), LANES),
        }
        pack = None
        if packed:
            host, pack = pack_component_dict(host)
        return host, pack

    @staticmethod
    def from_plan(plan: Plan, packed: bool = False,
                  device=None) -> "PlanArrays":
        dev = resolve_device(device)
        host, pack = PlanArrays.host_arrays(plan, packed)
        arrays = {c: torch.from_numpy(a).to(dev) for c, a in host.items()}
        if isinstance(plan, PlainPlan):
            return PlanArrays(kind="plain", w_in=plan.w_in,
                              w_out=plan.w_out, arrays=arrays)
        return PlanArrays(
            kind="decomposed", w_in=plan.w_in, w_out=plan.w_out,
            l=plan.l, w_lb=plan.w_lb, w_hb=plan.w_hb, arrays=arrays,
            pack=pack)


# -------------------------------------------------------------------------
# launch wrappers
# -------------------------------------------------------------------------
def fault_hook(point: str) -> None:
    """Fire ``point`` in the serving control plane's fault injectors
    (:mod:`repro_torch.serve.faults`): ``cuda:lut_act``,
    ``cuda:lut_act_stacked``, ``cuda:lut_act_multi`` and
    ``cuda:lut_reconstruct`` at their wrappers' entry, ``gather:lut_act``
    in the gather evaluator (``nn/mlp.py::apply_lut_act``).  The module is
    found through ``sys.modules``, so the kernels never import the
    serving layer and pay one dict lookup when nothing imported it.  A
    wrapper's Python runs on an eager call and while a CUDA graph is
    captured, never at a replay: an armed fault surfaces at an eager step
    or at (re)capture."""
    faults = sys.modules.get("repro_torch.serve.faults")
    if faults is not None and faults._ACTIVE:
        faults.fault_point(point)


# launch tallies of the CUDA graph captures in progress, innermost last
_RECORDING: list[dict] = []


def note_launch(point: str, n: int = 1) -> None:
    """Count ``n`` launches at ``point`` (``"cuda:lut_act_stacked"``, or a
    gather evaluator's ``"gather:lut_act"``) in the active telemetry's
    ``kernel_launches_total``.  Inside :func:`recording` the launches go
    to the recording's tally instead: a CUDA graph's capture counts
    nothing itself, and its replays add what it recorded
    (:func:`note_launches`).  The telemetry module is found through
    ``sys.modules``, so the kernels never import ``obs`` and pay one dict
    lookup when nothing imported it."""
    if _RECORDING:
        tally = _RECORDING[-1]
        tally[point] = tally.get(point, 0) + n
        return
    obs = sys.modules.get("repro_torch.obs.telemetry")
    if obs is not None and obs._STACK:
        obs.kernel_launch(point, n)


def note_launches(tally: dict) -> None:
    """:func:`note_launch` for every ``point: n`` of ``tally``."""
    for point, n in tally.items():
        note_launch(point, n)


@contextlib.contextmanager
def recording():
    """Collect the launch points noted inside into a dict (yielded) instead
    of counting them: what one captured step launches at each replay."""
    tally: dict = {}
    _RECORDING.append(tally)
    try:
        yield tally
    finally:
        _RECORDING.remove(tally)


def _launched(wrapper, reads=(), writes=(), table_bytes: int = 0,
              flops: float = 0) -> None:
    """One launch of ``wrapper``'s kernel: its count and its point, and
    its cost for the roofline's counter (found through ``sys.modules``,
    as telemetry is): the tensors it reads and writes, ``table_bytes`` of
    tables read through a launch record (or a function giving them, asked
    only while the counter runs), ``flops``.  Inside
    :func:`abstract` only the counter hears of it: nothing launched."""
    point = "cuda:" + wrapper.__name__
    costs = sys.modules.get("repro_torch.roofline.costs")
    if costs is not None and costs._ACTIVE:
        if callable(table_bytes):
            table_bytes = table_bytes()
        costs.note_kernel(point, reads, writes, table_bytes, flops)
    if is_abstract():
        return
    wrapper.launches += 1
    note_launch(point)


def _kernel_operands(name: str, x: torch.Tensor, tables) -> torch.Tensor:
    """Validate a kernel launch: ``x`` on the card in a supported dtype,
    every table tensor on the same card.  Returns ``x`` contiguous."""
    if not on_card(x.device):
        raise ValueError(
            f"{name}: input on {x.device}; the kernel runs on a CUDA "
            f"tensor and the plain version on a CPU one")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(
            f"{name}: dtype {x.dtype} not supported (float32, bfloat16)")
    for t in tables:
        if t.device != x.device:
            raise ValueError(
                f"{name}: table tensor on {t.device}, input on "
                f"{x.device} — tables must live on the input's card")
    return x.contiguous()


def lut_act(x: torch.Tensor, pa: PlanArrays, *, x_lo: float, x_hi: float,
            y_lo: float, y_hi: float, record=None) -> torch.Tensor:
    """K2: one plan's LUT activation over a float tensor of any shape and
    strides (the kernel reads a strided view in place).  ``record``: the
    launch record of the plan's site entry (``SitePlan.entry`` builds it
    with the entry); without one it is built per call
    (:func:`.lut_act.plan_record`)."""
    fault_hook("cuda:lut_act")
    if pa.kind != "decomposed":
        raise ValueError("lut_act expects a decomposed plan")
    kw = dict(l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb, w_in=pa.w_in,
              w_out=pa.w_out, x_lo=x_lo, x_hi=x_hi)
    if x.device.type == "cpu":
        return lut_act_plain(x, pa.arrays, y_lo=y_lo, y_hi=y_hi,
                             pack=pa.pack, **kw)
    if record is None:
        record = plan_record(pa.arrays, pa.pack, y_lo=y_lo, y_hi=y_hi, **kw)
    return _launch_k1k2(lut_act, "rlut_lut_act", x, record, 0)


def lut_act_stacked(x: torch.Tensor, stacked: dict, layer: int
                    ) -> torch.Tensor:
    """K1: layer ``layer`` (a Python int) of a stacked entry
    (``StackedPlanArrays.entry()``, or a site's slice of the multi-site
    entry) over a float tensor of any shape and strides.  The launch
    record is the entry's own (``stacked["k1_record"]``), built with the
    entry; this only reads it."""
    fault_hook("cuda:lut_act_stacked")
    if x.device.type == "cpu":
        return lut_act_stacked_plain(x, stacked, layer)
    rec = stacked.get("k1_record")
    if rec is None:
        raise ValueError(
            "lut_act_stacked: the entry carries no launch record "
            "('k1_record'); build it with StackedPlanArrays.entry() or "
            "multi_site_stacked_entry() of a MultiSiteSlabs.entry()")
    return _launch_k1k2(lut_act_stacked, "rlut_lut_act_stacked", x, rec,
                        layer)


def _launch_k1k2(wrapper, entry: str, x: torch.Tensor, rec,
                 layer: int) -> torch.Tensor:
    from . import build

    if x.numel() == 0:
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    check_data(wrapper.__name__, x)
    fn = None if is_abstract() else build.entry(entry)
    y = launch_lut(fn, wrapper.__name__, x, rec, layer)
    _launched(wrapper, (x,), (y,), rec.layer_bytes)
    return y


def lut_act_multi(xs: dict, entry: dict, layer: int) -> dict:
    """K4: ``{site: y}`` for ``{site: x}`` (each any shape) against a
    multi-site entry (``MultiSiteSlabs.entry()``) at ``layer`` (a Python
    int), in ONE launch: each non-empty tensor is one segment, at most
    ``MAX_SEGMENTS``.  All tensors on the CPU go to the plain version;
    on the card they must share one dtype (float32 or bfloat16) — a mix
    is refused, not converted.  The launch record is the entry's own
    (``entry["k4_record"]``), built with the entry; this only reads it."""
    fault_hook("cuda:lut_act_multi")
    order = entry["meta"]["sites"]
    for site in xs:
        if site not in order:
            raise KeyError(f"lut_act_multi: site {site!r} is not in the "
                           f"super-slab {order}")
    if all(x.device.type == "cpu" for x in xs.values()):
        return lut_act_multi_plain(xs, entry, layer)
    rec = entry.get("k4_record")
    if rec is None:
        raise ValueError(
            "lut_act_multi: the entry carries no launch record "
            "('k4_record'); build it with MultiSiteSlabs.entry()")
    check_data("lut_act_multi", *xs.values())
    out, call = k4_call(xs, rec, layer)
    if call is not None:
        if not is_abstract():
            launch_multi(call, rec)
        _launched(lut_act_multi, call[2], [out[s] for s in xs],
                  sum(rec.records[rec.site_ids[s]].layer_bytes
                      for s, x in xs.items() if x.numel()))
    return out


def fused_matmul_lut(x: torch.Tensor, w: torch.Tensor, tab: dict, *,
                     gated: bool, epilogue: bool = True) -> torch.Tensor:
    """K3: ``act(x @ w)`` (or ``act(gate) * up``) for ``x`` of shape
    ``(..., K)`` and ``w`` of shape ``(K, N)``; ``epilogue=False`` returns
    the kernel's GEMM alone, rounded to the model dtype."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, k)
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"fused_matmul_lut: w {tuple(w.shape)} does not "
                         f"contract with x {tuple(x.shape)}")
    if gated and w.shape[1] % 2:
        raise ValueError(f"fused_matmul_lut: gated needs even N, got "
                         f"{w.shape[1]}")
    if x.device.type == "cpu":
        out = fused_matmul_lut_plain(x2d, w, tab, gated=gated,
                                     epilogue=epilogue)
        return out.reshape(*lead, out.shape[-1])
    if w.dtype != x.dtype:
        raise ValueError(f"fused_matmul_lut: w dtype {w.dtype} != x dtype "
                         f"{x.dtype}")
    if k == 0:
        raise ValueError("fused_matmul_lut: empty contraction (K = 0)")
    x2d = _kernel_operands("fused_matmul_lut", x2d, [w])
    check_data("fused_matmul_lut", x2d, w)
    w = w.contiguous()
    out = fused_matmul_lut_cuda(x2d, w, tab, gated=gated, epilogue=epilogue)
    _launched(fused_matmul_lut, (x2d, w), (out,),
              (lambda: lut_record(tab)[0].layer_bytes) if epilogue else 0,
              2.0 * x2d.shape[0] * w.shape[1] * k)
    return out.reshape(*lead, out.shape[-1])


def _int_operands(name: str, x: torch.Tensor, tables) -> torch.Tensor:
    """Validate an integer-kernel launch: ``x`` of an integer dtype,
    every table a contiguous int32 tensor on ``x``'s card.  Returns ``x``
    as contiguous int32."""
    if not on_card(x.device):
        raise ValueError(
            f"{name}: input on {x.device}; the kernel runs on a CUDA "
            f"tensor and the plain version on a CPU one")
    if x.dtype.is_floating_point or x.dtype.is_complex or \
            x.dtype == torch.bool:
        raise ValueError(f"{name}: addresses and codes must be integers, "
                         f"got {x.dtype}")
    for t in tables:
        if t.device != x.device:
            raise ValueError(
                f"{name}: table tensor on {t.device}, input on "
                f"{x.device} — tables must live on the input's card")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tables must be contiguous int32, "
                             f"got {t.dtype}")
    return x.to(torch.int32).contiguous()


def plain_lookup(x: torch.Tensor, pa: PlanArrays) -> torch.Tensor:
    """K6: a plain plan's table at int addresses ``x`` (any shape), as
    int32 of ``x``'s shape."""
    if pa.kind != "plain":
        raise ValueError("plain_lookup expects a plain plan")
    table = pa.arrays["table"]
    if x.device.type == "cpu":
        return plain_lookup_plain(x, table)
    xc = _int_operands("plain_lookup", x, [table])
    check_data("plain_lookup", xc, table)
    if xc.numel() == 0:
        return torch.empty_like(xc)
    out = (torch.empty_like(xc) if is_abstract()
           else plain_lookup_cuda(xc, table))
    _launched(plain_lookup, (xc, table), (out,))
    return out


def lut_reconstruct(x: torch.Tensor, pa: PlanArrays) -> torch.Tensor:
    """Evaluate a compressed table at int addresses ``x`` (any shape):
    K5 (Eq. (1)) for a decomposed plan, K6 (:func:`plain_lookup`) for a
    plain one.  Addresses lie in ``[0, 2^w_in)``."""
    fault_hook("cuda:lut_reconstruct")
    if pa.kind == "plain":
        return plain_lookup(x, pa)
    if pa.pack is not None:
        raise ValueError("lut_reconstruct takes raw int32 component "
                         "arrays (PlanArrays.from_plan(plan, packed=False))")
    kw = dict(l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb)
    a = pa.arrays
    if x.device.type == "cpu":
        return lut_reconstruct_plain(x, *(a[c] for c in COMPONENTS), **kw)
    xc = _int_operands("lut_reconstruct", x, a.values())
    check_data("lut_reconstruct", xc, *a.values())
    if xc.numel() == 0:
        return torch.empty_like(xc)
    out = (torch.empty_like(xc) if is_abstract()
           else lut_reconstruct_cuda(xc, a, **kw))
    _launched(lut_reconstruct, (xc, *a.values()), (out,))
    return out


def lutnn_layer(codes: torch.Tensor, conn: torch.Tensor,
                tables: torch.Tensor, *, bits: int) -> torch.Tensor:
    """K7: one LUT-NN layer — parent codes ``(B, P)``, wiring ``(N, F)``,
    truth tables ``(N, T)`` with ``T >= 2^(bits*F)`` -> output codes
    ``(B, N)`` int32.  Rejects ``bits * F > 24``."""
    if codes.dim() != 2 or conn.dim() != 2 or tables.dim() != 2:
        raise ValueError(
            f"lutnn_layer: codes (B, P), conn (N, F) and tables (N, T) "
            f"must be 2-D, got {tuple(codes.shape)}, {tuple(conn.shape)}, "
            f"{tuple(tables.shape)}")
    n, f = conn.shape
    if (tables.shape[0] != n or bits < 1 or f < 1
            or bits * f > MAX_ADDR_BITS
            or tables.shape[1] < (1 << (bits * f)) or codes.shape[1] < 1):
        raise ValueError(
            f"lutnn_layer: bits {bits} x fan-in {f} must be in "
            f"[1, {MAX_ADDR_BITS}] with tables (N={n}, T >= "
            f"2^(bits*F)) and P >= 1; got tables {tuple(tables.shape)}, "
            f"codes {tuple(codes.shape)}")
    if codes.device.type == "cpu":
        return lutnn_layer_plain(codes, conn, tables, bits=bits)
    cc = _int_operands("lutnn_layer", codes, [tables])
    check_data("lutnn_layer", cc, conn, tables)
    if conn.device != cc.device:
        raise ValueError(f"lutnn_layer: conn on {conn.device}, codes on "
                         f"{cc.device}")
    conn = conn.to(torch.int32).contiguous()
    out = (torch.empty((cc.shape[0], n), dtype=torch.int32, device=cc.device)
           if is_abstract() else lutnn_layer_cuda(cc, conn, tables, bits=bits))
    if out.numel():
        _launched(lutnn_layer, (cc, conn, tables), (out,))
    return out


def _wkv_check(q, k, v, log_w, u, chunk, state) -> None:
    b, t, h, n = q.shape
    for name, a in (("k", k), ("v", v), ("log_w", log_w)):
        if a.shape != q.shape:
            raise ValueError(f"wkv: {name} {tuple(a.shape)} != q "
                             f"{tuple(q.shape)}")
    if u.shape != (h, n) or chunk < 1 or (
            state is not None and state.shape != (b, h, n, n)):
        raise ValueError(
            f"wkv: u {tuple(u.shape)} must be ({h}, {n}), chunk {chunk} "
            f">= 1, state (B, H, N, N) or None")
    if q.device.type != "cpu" and not on_card(q.device):
        raise ValueError(f"wkv: input on {q.device}")
    for a in (k, v, log_w, u) + (() if state is None else (state,)):
        if a.device != q.device:
            raise ValueError(f"wkv: tensor on {a.device}, q on {q.device}")


def _f32(a, dev):
    """``a`` as a contiguous float32 tensor on ``dev``, 16-byte aligned (a
    tensor of the abstract route has no pointer: the caching allocator's
    blocks are aligned, so a fresh one would be)."""
    a = a.to(device=dev, dtype=torch.float32).contiguous()
    return a.clone() if not is_abstract() and a.data_ptr() % 16 else a


def _wkv_forward(q, k, v, log_w, u, chunk, state):
    if q.device.type == "cpu":
        return wkv_chunked_plain(q, k, v, log_w, u, chunk=chunk,
                                 state=state)
    check_data("wkv", q, k, v, log_w, u, state)
    ins = [_f32(a, q.device) for a in (q, k, v, log_w, u)]
    st = None if state is None else _f32(state, q.device)
    y, s = wkv_cuda(*ins, chunk, st)
    _launched(wkv, (*ins, st), (y, s))
    return y, s


class _WKV(torch.autograd.Function):
    """K8 forward, K8b backward (their plain versions on the CPU).  The
    gradient covers q, k, v, log_w and u; the initial state may be given
    but takes no gradient, and the final state must not reach the loss."""

    @staticmethod
    def forward(ctx, q, k, v, log_w, u, chunk, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, log_w, u, state)
        return _wkv_forward(q, k, v, log_w, u, chunk, state)

    @staticmethod
    def backward(ctx, dy, d_state):
        if d_state is not None:
            raise RuntimeError(
                "wkv: no gradient flows into the final state (K8b starts "
                "its reverse pass from G_T = 0); a loss may use y only")
        q, k, v, log_w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        grads = wkv_backward(q, k, v, log_w, u, dy, state=state)
        return (*(g.to(a.dtype) for g, a in zip(grads, (q, k, v, log_w, u))),
                None, None)


def wkv(q, k, v, log_w, u, *, chunk: int = 16, state=None):
    """K8: chunked RWKV6 WKV.  ``q``/``k``/``v``/``log_w`` ``(B, T, H,
    N)`` (any float dtype; the kernel computes in float32), ``u`` ``(H,
    N)``, ``state`` ``(B, H, N, N)`` or ``None`` (zeros).  Returns ``(y
    (B, T, H, N), final state (B, H, N, N))``, both float32.

    Differentiable with respect to q, k, v, log_w and u when one of them
    requires a gradient (training): the backward is K8b
    (:func:`wkv_backward`).  A ``state`` that requires a gradient is
    refused."""
    _wkv_check(q, k, v, log_w, u, chunk, state)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (q, k, v, log_w, u)):
        if state is not None and state.requires_grad:
            raise ValueError("wkv: no gradient with respect to the initial "
                             "state (K8b gives q, k, v, log_w and u's)")
        return _WKV.apply(q, k, v, log_w, u, chunk, state)
    return _wkv_forward(q, k, v, log_w, u, chunk, state)


def wkv_backward(q, k, v, log_w, u, dy, *, state=None):
    """K8b: the backward of :func:`wkv` against ``dy = dL/dy`` (B, T, H,
    N), from the initial ``state`` (``None``: zeros) — ``(dq, dk, dv,
    dlog_w (B, T, H, N), du (H, N))``, float32.  On the card N must be one
    of ``K8B_HEAD_SIZES`` (``wkv.k8b_plan`` raises otherwise)."""
    _wkv_check(q, k, v, log_w, u, 1, state)
    if dy.shape != q.shape or dy.device != q.device:
        raise ValueError(f"wkv_backward: dy {tuple(dy.shape)} on "
                         f"{dy.device}, q {tuple(q.shape)} on {q.device}")
    if q.device.type == "cpu":
        return wkv_backward_plain(q, k, v, log_w, u, dy, state=state)
    check_data("wkv_backward", q, k, v, log_w, u, dy, state)
    # k8b_plan refuses other head sizes
    ins = [_f32(a, q.device) for a in (q, k, v, log_w, u, dy)]
    st = None if state is None else _f32(state, q.device)
    out = wkv_backward_cuda(*ins, st)
    _launched(wkv_backward, (*ins, st), out)
    return out


WRAPPERS = {"lut_act_stacked": lut_act_stacked, "lut_act": lut_act,
            "fused_matmul_lut": fused_matmul_lut,
            "lut_act_multi": lut_act_multi,
            "lut_reconstruct": lut_reconstruct,
            "plain_lookup": plain_lookup, "lutnn_layer": lutnn_layer,
            "wkv": wkv, "wkv_backward": wkv_backward}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (wrapper name -> launches, negative to take away) to
    the wrappers' counts: a CUDA graph's replay launches the kernels its
    capture recorded, and the capture itself launches none."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n
