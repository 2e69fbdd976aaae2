"""LUT-compressed nonlinearities for LM architectures (PyTorch port of the
reference's ``nn/lut_act.py``; the table building is numpy and identical).

The paper's pipeline, applied to an activation function:
  1. tabulate g(x) on a uniform ``2^w_in`` input grid over [x_lo, x_hi],
     quantizing outputs to ``w_out`` bits over [y_lo, y_hi];
  2. run calibration batches and mark *unobserved input bins* as don't
     cares (same rule as unobserved L-LUT inputs, paper SS4.1);
  3. compress with ReducedLUT — don't cares let the decomposer rewrite
     unused bins to expose self-similarities;
  4. evaluate at runtime via the CUDA kernels (``repro_torch.kernels``)
     or the plain gather form.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import CompressConfig, TableSpec, compress_table
from repro_torch.core.plan import DecomposedPlan, Plan
from repro_torch.kernels import PlanArrays

ACT_FNS = {
    "gelu": lambda x: x * 0.5 * (1 + np.tanh(
        np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3))),
    "silu": lambda x: x / (1 + np.exp(-x)),
    "swiglu": lambda x: x / (1 + np.exp(-x)),
    "geglu": lambda x: x * 0.5 * (1 + np.tanh(
        np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3))),
    "relu2": lambda x: np.square(np.maximum(x, 0.0)),
    "exp": np.exp,
    "sigmoid": lambda x: 1 / (1 + np.exp(-x)),
    "rsqrt": lambda x: 1.0 / np.sqrt(x),
    "tanh": np.tanh,
    "sin": np.sin,
}


@dataclasses.dataclass
class LUTActivation:
    plan: Plan
    w_in: int
    w_out: int
    x_lo: float
    x_hi: float
    y_lo: float
    y_hi: float
    dontcare_frac: float

    def meta(self) -> dict:
        p = self.plan
        assert isinstance(p, DecomposedPlan)
        return {
            "l": p.l, "w_lb": p.w_lb, "w_hb": p.w_hb,
            "w_in": self.w_in, "w_out": self.w_out,
            "x_lo": self.x_lo, "x_hi": self.x_hi,
            "y_lo": self.y_lo, "y_hi": self.y_hi,
        }

    def tables_for_model(self, device=None) -> dict:
        """The site entry consumed by :func:`repro_torch.nn.mlp.
        make_activation` (raw int32 arrays on ``device``)."""
        pa = PlanArrays.from_plan(self.plan, device=device)
        return {"meta": self.meta(), "arrays": pa.arrays}

    def plan_arrays(self, packed: bool = False, device=None) -> PlanArrays:
        return PlanArrays.from_plan(self.plan, packed=packed, device=device)


def calibrate_bins(samples: np.ndarray, w_in: int, x_lo: float,
                   x_hi: float) -> np.ndarray:
    """Observed-bin mask from calibration activations (care mask).

    Degenerate inputs raise instead of silently producing an all- or
    near-all-don't-care table the compressor may rewrite into garbage:
    an empty/non-finite calibration set, an inverted or zero-width input
    range, or a constant calibration array (one observed bin).
    """
    if x_hi <= x_lo:
        raise ValueError(
            f"calibrate_bins: empty input range [x_lo={x_lo}, x_hi={x_hi}]")
    flat = np.asarray(samples, dtype=np.float64).reshape(-1)
    flat = flat[np.isfinite(flat)]
    if flat.size == 0:
        raise ValueError(
            "calibrate_bins: calibration array is empty (or all non-finite) "
            "— the resulting all-don't-care table is unconstrained and the "
            "compressor may rewrite every entry")
    levels = (1 << w_in) - 1
    xn = np.clip((flat - x_lo) / (x_hi - x_lo), 0.0, 1.0)
    codes = np.rint(xn * levels).astype(np.int64)
    care = np.zeros(1 << w_in, dtype=bool)
    care[codes] = True
    if int(care.sum()) < 2:
        raise ValueError(
            "calibrate_bins: calibration is constant (a single observed "
            "bin); the table would be all-don't-care away from one entry — "
            "pass a representative activation sample instead")
    return care


def activation_table(
    act: str,
    calibration: np.ndarray | None = None,
    *,
    care: np.ndarray | None = None,
    w_in: int = 10,
    w_out: int = 10,
    x_lo: float = -8.0,
    x_hi: float = 8.0,
    name: str | None = None,
) -> tuple[TableSpec, dict]:
    """Tabulate + quantize an activation into a compressor-ready spec.

    The care mask comes either from raw ``calibration`` samples (binned by
    :func:`calibrate_bins`) or directly as a precomputed ``care`` bool
    vector (the per-site streaming-calibration path,
    :mod:`repro_torch.calib.masks`).  Returns ``(TableSpec, quant)`` where
    ``quant`` carries the output dequantization range (``y_lo``/``y_hi``,
    computed over *care* bins only — don't-care bins are never served, so
    letting them widen the range would just coarsen the output grid) and
    ``dontcare_frac``.
    """
    if x_hi <= x_lo:
        raise ValueError(
            f"activation_table: empty input range "
            f"[x_lo={x_lo}, x_hi={x_hi}]")
    if w_out < 2:
        raise ValueError(
            f"activation_table: w_out={w_out} leaves fewer than two output "
            f"levels — the served table would be (near-)constant")
    if care is not None and calibration is not None:
        raise ValueError(
            "activation_table: pass either raw calibration samples or a "
            "precomputed care mask, not both")
    fn = ACT_FNS[act]
    xs = np.linspace(x_lo, x_hi, 1 << w_in)
    ys = fn(xs)
    if care is not None:
        care = np.asarray(care, dtype=bool)
        if care.shape != (1 << w_in,):
            raise ValueError(
                f"activation_table: care mask shape {care.shape} != "
                f"({1 << w_in},) for w_in={w_in}")
        if int(care.sum()) < 2:
            raise ValueError(
                "activation_table: care mask keeps fewer than two bins — "
                "the table would be unconstrained away from one entry")
    elif calibration is not None:
        care = calibrate_bins(np.asarray(calibration), w_in, x_lo, x_hi)
    ys_care = ys if care is None else ys[care]
    y_lo, y_hi = float(ys_care.min()), float(ys_care.max())
    span = max(y_hi - y_lo, 1e-6)
    codes = np.clip(
        np.rint((ys - y_lo) / span * ((1 << w_out) - 1)),
        0, (1 << w_out) - 1).astype(np.int64)
    codes_care = codes if care is None else codes[care]
    if np.unique(ys_care).size >= 2 and np.unique(codes_care).size < 2:
        # The care bins carry distinct outputs but the quantizer collapses
        # them all onto one code (the observed span is below the 1e-6
        # resolution floor): the table would serve a constant where the
        # activation varies — a degenerate quantizer the engine would
        # happily compress into nonsense.
        raise ValueError(
            f"activation_table[{name or f'act_{act}'}]: w_out={w_out} "
            f"cannot represent the observed output range "
            f"[{y_lo:.3g}, {y_hi:.3g}] — all {int(codes_care.size)} care "
            f"bins quantize to a single output code; widen the care mask "
            f"or raise w_out")
    spec = TableSpec(codes, w_in, w_out, care=care,
                     name=name or f"act_{act}")
    quant = {
        "y_lo": y_lo, "y_hi": y_hi,
        "dontcare_frac": float(0.0 if care is None else 1 - care.mean()),
    }
    return spec, quant


def ensure_decomposed(plan, spec: TableSpec,
                      exiguity: int | None = 250) -> DecomposedPlan:
    """Force an Eq. (1) decomposition when the search picked plain — the
    runtime activation evaluators only consume decomposed plan arrays."""
    if isinstance(plan, DecomposedPlan):
        return plan
    from repro_torch.core.pipeline import _decompose_hb

    # m must divide the table length: narrow tables (w_in < 5) take the
    # whole table as one sub-table instead of the default 32
    m = min(32, 1 << spec.w_in)
    cfg = CompressConfig(exiguity=exiguity, m_candidates=(m,),
                         lb_candidates=(0,))
    return _decompose_hb(spec.values, spec.care_mask(), spec.w_in,
                         spec.w_out, 0, None, m, cfg, spec.name)


def lut_activation_from_plan(plan, spec: TableSpec, quant: dict, *,
                             x_lo: float, x_hi: float,
                             exiguity: int | None = 250) -> LUTActivation:
    """Wrap an engine-selected plan + quantization meta for the runtime."""
    return LUTActivation(
        plan=ensure_decomposed(plan, spec, exiguity),
        w_in=spec.w_in, w_out=spec.w_out, x_lo=x_lo, x_hi=x_hi,
        y_lo=quant["y_lo"], y_hi=quant["y_hi"],
        dontcare_frac=quant["dontcare_frac"],
    )


def build_lut_activation(
    act: str,
    calibration: np.ndarray | None = None,
    *,
    w_in: int = 10,
    w_out: int = 10,
    x_lo: float = -8.0,
    x_hi: float = 8.0,
    exiguity: int | None = 250,
    m_candidates=(8, 16, 32, 64),
    lb_candidates=(0, 1, 2, 3),
) -> LUTActivation:
    """Single-table convenience path (one activation, compressed inline).
    Network-level serving goes through :func:`repro_torch.serve.plans.
    build_serving_plans`, which dedupes identical tables across sites."""
    spec, quant = activation_table(
        act, calibration, w_in=w_in, w_out=w_out, x_lo=x_lo, x_hi=x_hi)
    cfg = CompressConfig(exiguity=exiguity, m_candidates=m_candidates,
                         lb_candidates=lb_candidates)
    plan = compress_table(spec, cfg)
    return lut_activation_from_plan(plan, spec, quant, x_lo=x_lo, x_hi=x_hi,
                                    exiguity=exiguity)
