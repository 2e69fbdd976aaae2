"""Plan slabs and the launch wrappers of the LUT kernels.

Counterpart of the reference's ``kernels/ops.py``:

* :class:`PlanArrays` — one plan's lane-padded component arrays, padded
  to 128 entries exactly as the reference pads them, so the slabs (raw or
  bit-packed) are byte-identical across the two packages;
* :func:`lut_act` (K2), :func:`lut_act_stacked` (K1) and
  :func:`fused_matmul_lut` (K3) — the launch wrappers.  A tensor on the
  CPU goes to the kernel's plain version; a tensor on the card goes to the
  kernel, or the wrapper raises.  Each wrapper counts its kernel launches
  in a plain integer attribute (``lut_act_stacked.launches``), so a run
  can show that it went through the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.plan import DecomposedPlan, Plan
from repro_torch.device import resolve_device

from .fused_matmul_lut import fused_matmul_lut_cuda, fused_matmul_lut_plain
from .lut_act import (
    DTYPE_CODES,
    launch_lut,
    lut_act_plain,
    lut_act_stacked_plain,
    lut_launch_args,
)
from .packing import COMPONENTS, pack_component_dict

LANES = 128


def _pad_to(a: np.ndarray, mult: int) -> np.ndarray:
    n = a.shape[0]
    pad = (-n) % mult
    if pad:
        a = np.concatenate([a, np.zeros(pad, a.dtype)])
    return a


@dataclasses.dataclass
class PlanArrays:
    """Device-ready, lane-padded arrays for one compression plan.

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
        if not isinstance(plan, DecomposedPlan):
            raise ValueError(
                "PlanArrays: the LUT kernels take decomposed plans (the "
                "plain-table lookup is kernel K6, not ported yet)")
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
        return PlanArrays(
            kind="decomposed", w_in=plan.w_in, w_out=plan.w_out,
            l=plan.l, w_lb=plan.w_lb, w_hb=plan.w_hb, arrays=arrays,
            pack=pack)


# -------------------------------------------------------------------------
# launch wrappers
# -------------------------------------------------------------------------
def _kernel_operands(name: str, x: torch.Tensor, tables) -> torch.Tensor:
    """Validate a kernel launch: ``x`` on the card in a supported dtype,
    every table tensor on the same card.  Returns ``x`` contiguous."""
    if x.device.type != "cuda":
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
            y_lo: float, y_hi: float) -> torch.Tensor:
    """K2: one plan's LUT activation over a float tensor of any shape."""
    if pa.kind != "decomposed":
        raise ValueError("lut_act expects a decomposed plan")
    kw = dict(l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb, w_in=pa.w_in,
              w_out=pa.w_out, x_lo=x_lo, x_hi=x_hi)
    if x.device.type == "cpu":
        return lut_act_plain(x, pa.arrays, y_lo=y_lo, y_hi=y_hi,
                             pack=pa.pack, **kw)
    xc = _kernel_operands("lut_act", x, pa.arrays.values())
    from . import build

    args = lut_launch_args(pa.arrays, pa.pack, any_lb=pa.w_lb > 0,
                           y_lo=y_lo, y_hi=y_hi, **kw)
    y = launch_lut(build.entry("rlut_lut_act"), "lut_act", xc, args)
    lut_act.launches += 1
    return y.view(x.shape)


def lut_act_stacked(x: torch.Tensor, stacked: dict, layer: int
                    ) -> torch.Tensor:
    """K1: layer ``layer`` (a Python int) of a stacked entry
    (``StackedPlanArrays.entry()``) over a float tensor of any shape."""
    if x.device.type == "cpu":
        return lut_act_stacked_plain(x, stacked, layer)
    meta = stacked["meta"]
    rows = {c: stacked["arrays"][c][layer] for c in COMPONENTS}
    mi, mf = stacked["meta_i"][layer], stacked["meta_f"][layer]
    xc = _kernel_operands("lut_act_stacked", x, [*rows.values(), mi, mf])
    from . import build

    args = lut_launch_args(
        rows, meta.get("pack"), any_lb=meta["any_lb"], w_in=meta["w_in"],
        w_out=meta["w_out"], x_lo=meta["x_lo"], x_hi=meta["x_hi"],
        meta_i=mi, meta_f=mf)
    y = launch_lut(build.entry("rlut_lut_act_stacked"), "lut_act_stacked",
                   xc, args)
    lut_act_stacked.launches += 1
    return y.view(x.shape)


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
    tables = [w]
    if epilogue:
        tables += [t for t in _tab_tensors(tab)]
    x2d = _kernel_operands("fused_matmul_lut", x2d, tables)
    out = fused_matmul_lut_cuda(x2d, w.contiguous(), tab, gated=gated,
                                epilogue=epilogue)
    fused_matmul_lut.launches += 1
    return out.reshape(*lead, out.shape[-1])


def _tab_tensors(tab: dict):
    from .fused_matmul_lut import stacked_parts

    arrays, meta_i, meta_f, _, _ = stacked_parts(tab)
    yield from arrays.values()
    if meta_i is not None:
        yield meta_i
        yield meta_f


WRAPPERS = {"lut_act_stacked": lut_act_stacked, "lut_act": lut_act,
            "fused_matmul_lut": fused_matmul_lut}
for _fn in WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
