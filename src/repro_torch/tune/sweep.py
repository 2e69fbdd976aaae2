"""Don't-care knob sweep: one capture, many plans, measured quality each
(PyTorch port of the reference's ``tune/sweep.py``; the decisions are
the reference's, line for line, and the tables reach the parameters'
device on the port's backends, ``"gather"`` or ``"cuda"``: kernel K1 on
packed stacked slabs, K2 under ``plan_exec="unrolled"``).

The sweep axes are the paper's don't-care knobs (``min_count`` /
``coverage`` / ``smoothing``, :mod:`repro_torch.calib.masks`) plus the
table
widths (``w_in`` / ``w_out``).  Three reuse mechanisms keep a grid of
points tractable:

* **one capture** — histograms are captured once at the widest ``w_in``
  and folded down (:func:`repro_torch.calib.fold_hist`) for narrower
  candidates; output ranges are width-independent and shared as-is;
* **plan cache** — every ``build_serving_plans`` call shares one
  :class:`~repro_torch.core.PlanCache`, so a ``(values, care, widths)``
  spec that recurs across points (an insensitive site whose mask did not
  change) is never recompressed;
* **one baseline** — the float reference logits are computed once by the
  :class:`~repro_torch.tune.parity.ParityHarness` and every point only
  pays its own compressed forward.

``w_out="auto"`` derives per-site output widths from the captured output
ranges (:func:`w_out_from_ranges`): a site whose observed outputs span a
fraction of the activation's full range keeps the default width's
*resolution* with fewer bits — the ROADMAP's "per-site w_out selection
from the captured output ranges".
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from repro_torch import sites as site_registry
from repro_torch.calib import (
    CalibrationSet,
    care_mask_from_hist,
    fold_hist,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import PlanCache
from repro_torch.nn.lut_act import ACT_FNS
from repro_torch.serve.plans import (
    ServingPlans,
    activation_sites,
    build_serving_plans,
)

from .parity import ParityHarness, ParityMetrics
from .pareto import greedy_select, pareto_frontier, select_by_budget


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One knob configuration.  ``w_in=None`` means the capture grid's
    width; ``w_out=None`` the config default; ``w_out="auto"`` per-site
    widths derived from the captured output ranges."""

    min_count: int = 1
    smoothing: int = 0
    coverage: float | None = None
    w_in: int | None = None
    w_out: int | str | None = None

    def label(self) -> str:
        parts = [f"mc{self.min_count}"]
        if self.smoothing:
            parts.append(f"sm{self.smoothing}")
        if self.coverage is not None:
            parts.append(f"cov{self.coverage}")
        if self.w_in is not None:
            parts.append(f"wi{self.w_in}")
        if self.w_out is not None:
            parts.append(f"wo{self.w_out}")
        return "/".join(parts)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepResult:
    """One measured sweep point (or its rejection)."""

    point: SweepPoint
    w_out: int | dict | None = None     # resolved output width(s)
    cost: int = 0                       # served P-LUT cost (runtime tables)
    plain_cost: int = 0
    table_bytes: int = 0
    dedup_rate: float = 0.0
    cache_hits: int = 0
    compress_s: float = 0.0
    eval_s: float = 0.0                 # the parity evaluation's seconds
    site_costs: dict = dataclasses.field(default_factory=dict)
    metrics: ParityMetrics | None = None
    error: str | None = None            # degenerate point, skipped

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def drop(self) -> tuple[float, float, float]:
        """Frontier ordering key: top-1 drop (the budgeted metric), then
        mean KL (strictly positive and near-monotone in compression
        aggressiveness — a robust tie-break when agreement saturates),
        then ppl delta."""
        m = self.metrics
        return (m.top1_drop, m.kl, m.ppl_delta)

    def to_dict(self) -> dict:
        return {
            "point": self.point.to_dict(),
            "label": self.point.label(),
            "w_out": self.w_out,
            "cost": self.cost,
            "plain_cost": self.plain_cost,
            "table_bytes": self.table_bytes,
            "dedup_rate": round(self.dedup_rate, 4),
            "cache_hits": self.cache_hits,
            "compress_s": round(self.compress_s, 3),
            "eval_s": round(self.eval_s, 3),
            "site_costs": dict(self.site_costs),
            "metrics": self.metrics.to_dict() if self.metrics else None,
            "error": self.error,
        }


def default_grid(cfg: ArchConfig, quick: bool = False) -> list[SweepPoint]:
    """The stock sweep.  Point 0 is always the untuned default plan
    (default knobs at the config widths) — the comparison baseline the
    tuned selection must beat."""
    wi, wo = cfg.lut_act_bits_in, cfg.lut_act_bits_out
    if quick:
        return [
            SweepPoint(),
            SweepPoint(coverage=0.999),
            SweepPoint(w_in=wi - 2, w_out="auto", coverage=0.999),
        ]
    return [
        SweepPoint(),
        SweepPoint(min_count=2),
        SweepPoint(coverage=0.999),
        SweepPoint(min_count=2, smoothing=1, coverage=0.999),
        SweepPoint(w_out="auto"),
        SweepPoint(w_out="auto", coverage=0.999),
        SweepPoint(w_in=wi - 2),
        SweepPoint(w_in=wi - 2, w_out=wo - 2),
        SweepPoint(w_in=wi - 2, w_out="auto", coverage=0.999),
        SweepPoint(w_in=wi - 4, w_out="auto", coverage=0.999, min_count=2),
        # the lossy cheap end: quality measurably degrades down here, so
        # the frontier spans the real tradeoff instead of collapsing onto
        # the still-lossless regime
        SweepPoint(w_in=max(4, wi - 5), w_out="auto", coverage=0.99,
                   min_count=2),
        SweepPoint(w_in=max(4, wi - 6), w_out=max(4, wo - 6),
                   coverage=0.99, min_count=2),
    ]


# ---------------------------------------------------------------------------
# Calibration re-derivation (shared capture -> per-point CalibrationSet)
# ---------------------------------------------------------------------------
def calibration_for(capture, assignment, w_in: int | None = None,
                    ) -> CalibrationSet:
    """Derive a per-site CalibrationSet from one shared capture.

    ``capture`` is an :class:`~repro_torch.calib.ActivationCapture` (or any
    object with ``hists``/``w_in``/``x_lo``/``x_hi`` and optional
    ``ranges`` — a loaded v2 artifact works).  ``assignment`` maps site
    *kinds* to :class:`SweepPoint` knobs; a single SweepPoint applies to
    every kind.  ``w_in`` (default: the assignment's, else the capture's)
    folds the histograms onto a narrower grid.
    """
    if getattr(capture, "hists", None) is None:
        raise ValueError(
            "calibration_for: the capture/artifact has no histograms — "
            "masks cannot be re-derived with new knobs; re-capture (or "
            "save the calibration with hists included)")
    if isinstance(assignment, SweepPoint):
        assignment = {None: assignment}
    default = assignment.get(None)
    if w_in is None:
        widths = {p.w_in for p in assignment.values() if p.w_in is not None}
        if len(widths) > 1:
            raise ValueError(
                f"calibration_for: assignment mixes w_in {sorted(widths)} — "
                f"one capture grid serves one input width per plan build")
        w_in = widths.pop() if widths else capture.w_in
    masks: dict[str, np.ndarray] = {}
    hists: dict[str, np.ndarray] = {}
    for key, hist in capture.hists.items():
        kind = key.rsplit("/", 1)[-1]
        point = assignment.get(kind, default)
        if point is None:
            raise ValueError(
                f"calibration_for: no knobs assigned for site kind "
                f"{kind!r} (have {sorted(k for k in assignment if k)})")
        h = fold_hist(hist, w_in)
        try:
            masks[key] = care_mask_from_hist(
                h, min_count=point.min_count, smoothing=point.smoothing,
                coverage=point.coverage)
        except ValueError as e:
            raise ValueError(
                f"sweep point {point.label()} at site {key}: {e}") from e
        hists[key] = h
    ranges = getattr(capture, "ranges", None)
    if callable(getattr(capture, "observed_ranges", None)):
        ranges = capture.observed_ranges()
    return CalibrationSet(
        masks=masks, w_in=w_in, x_lo=capture.x_lo, x_hi=capture.x_hi,
        hists=hists, ranges=dict(ranges) if ranges else None,
        meta={"knobs": {str(k): p.to_dict()
                        for k, p in assignment.items()}})


def w_out_from_ranges(cfg: ArchConfig, calib: CalibrationSet,
                      base_w_out: int | None = None) -> dict[str, int]:
    """Per-site output widths from the captured output ranges.

    The default ``w_out`` prices the activation's *full* tabulated range;
    a site whose observed outputs span a fraction of it can keep the same
    output resolution (quantization step) with fewer bits.  Sites without
    a captured range (v1 artifacts) keep the base width.  Each site's
    full range is computed over its registry domain (falling back to the
    calibration's global grid) so e.g. the rsqrt site never tabulates
    negative inputs.
    """
    base = base_w_out or cfg.lut_act_bits_out
    w_in = calib.w_in or cfg.lut_act_bits_in
    out: dict[str, int] = {}
    for spec in site_registry.active_sites(cfg):
        site, act = spec.key, spec.fn_name(cfg)
        lo, hi = spec.domain() or (calib.x_lo, calib.x_hi)
        xs = np.linspace(lo, hi, 1 << w_in)
        ys = ACT_FNS[act](xs)
        full_span = float(ys.max() - ys.min())
        spans = []
        if calib.ranges:
            for key, r in calib.ranges.items():
                if key == site or key.endswith(f"/{site}"):
                    spans.append(float(r[1] - r[0]))
        if not spans or full_span <= 0:
            out[site] = base
            continue
        obs_span = max(spans)          # every layer's outputs must fit
        step = full_span / ((1 << base) - 1)
        need = math.ceil(math.log2(max(obs_span / step, 1.0) + 1))
        out[site] = int(min(base, max(4, need)))
    return out


def resolve_w_out(cfg: ArchConfig, calib: CalibrationSet,
                  point: SweepPoint) -> int | dict[str, int]:
    if point.w_out == "auto":
        return w_out_from_ranges(cfg, calib)
    return int(point.w_out or cfg.lut_act_bits_out)


def build_point_plans(cfg: ArchConfig, capture, assignment, *,
                      w_in: int | None = None,
                      plan_cache: PlanCache | None = None,
                      compress_cfg=None, workers: int | None = None,
                      backend: str = "gather",
                      plan_exec: str = "stacked") -> ServingPlans:
    """Capture + knob assignment -> served plans (one sweep point)."""
    calib = calibration_for(capture, assignment, w_in=w_in)
    if isinstance(assignment, SweepPoint):
        w_out = resolve_w_out(cfg, calib, assignment)
    else:
        w_out = {}
        default = assignment.get(None)
        for site, _ in activation_sites(cfg):
            point = assignment.get(site, default)
            per = resolve_w_out(cfg, calib, point)
            w_out[site] = per[site] if isinstance(per, dict) else per
    return build_serving_plans(
        cfg, calib, w_out=w_out, compress_cfg=compress_cfg,
        workers=workers, backend=backend, plan_exec=plan_exec,
        plan_cache=plan_cache)


# ---------------------------------------------------------------------------
# Sweep + autotune orchestration
# ---------------------------------------------------------------------------
def _measure(plans: ServingPlans, harness: ParityHarness, point: SweepPoint,
             w_out, backend: str, plan_exec: str) -> SweepResult:
    t0 = time.perf_counter()
    tables = plans.tables_for_model(backend=backend, plan_exec=plan_exec,
                                    device=harness.device)
    metrics = harness.evaluate(tables)
    eval_s = time.perf_counter() - t0
    return SweepResult(
        point=point, w_out=w_out, cost=plans.total_cost,
        plain_cost=plans.report.total_plain_cost,
        table_bytes=plans.table_bytes(plan_exec=plan_exec),
        dedup_rate=plans.report.dedup_rate,
        cache_hits=plans.report.cache_hits,
        compress_s=plans.report.seconds, eval_s=eval_s,
        site_costs={k: sp.cost for k, sp in plans.sites.items()},
        metrics=metrics)


def run_sweep(cfg: ArchConfig, capture, grid: list[SweepPoint],
              harness: ParityHarness, *,
              plan_cache: PlanCache | None = None,
              workers: int | None = None, backend: str = "gather",
              plan_exec: str = "stacked",
              verbose: bool = False, log=print) -> list[SweepResult]:
    """Measure every grid point; degenerate points (zero care bins, an
    unrepresentable w_out) are recorded as skipped, not fatal.  With
    ``verbose``, each point's line goes to ``log``."""
    plan_cache = plan_cache if plan_cache is not None else PlanCache()
    results: list[SweepResult] = []
    for point in grid:
        try:
            calib = calibration_for(capture, point)
            w_out = resolve_w_out(cfg, calib, point)
            plans = build_serving_plans(
                cfg, calib, w_out=w_out, workers=workers, backend=backend,
                plan_exec=plan_exec, plan_cache=plan_cache)
            res = _measure(plans, harness, point, w_out, backend, plan_exec)
        except ValueError as e:
            res = SweepResult(point=point, error=str(e))
        results.append(res)
        if verbose:
            if res.ok:
                log(f"  [{point.label()}] cost={res.cost} "
                    f"bytes={res.table_bytes} {res.metrics.summary()} "
                    f"(compress {res.compress_s:.3f}s, evaluate "
                    f"{res.eval_s:.3f}s)")
            else:
                log(f"  [{point.label()}] SKIPPED: {res.error}")
    return results


@dataclasses.dataclass
class TuneOutcome:
    """Everything the tuner decided, measured and built."""

    results: list[SweepResult]          # every sweep point
    frontier: list[SweepResult]         # non-dominated (cost, drop)
    default: SweepResult                # untuned default plan (grid[0])
    selected: SweepResult | None        # cheapest budget-feasible point
    assignment: dict[str, SweepPoint]   # per-site-kind final knobs
    plans: ServingPlans                 # final built plans
    metrics: ParityMetrics              # measured parity of final plans
    cost: int                           # final served P-LUT cost
    budget: float
    budget_met: bool
    greedy: dict                        # evals / history from greedy_select

    @property
    def improved(self) -> bool:
        """Strictly cheaper than the untuned default plan."""
        return self.default.ok and self.cost < self.default.cost

    def summary(self) -> str:
        state = "met" if self.budget_met else "NOT met"
        if self.default.ok and self.default.cost:
            base = (f"vs default {self.default.cost} "
                    f"({1 - self.cost / self.default.cost:.1%} saved)")
        else:
            base = "(default point was rejected as degenerate)"
        return (f"tuned {self.cost} P-LUTs {base} | budget {self.budget} "
                f"{state} | {self.metrics.summary()} | "
                f"{len(self.frontier)} frontier points, "
                f"{self.greedy.get('evals', 0)} greedy evals")


def autotune(cfg: ArchConfig, params, capture, batches: list[dict], *,
             grid: list[SweepPoint] | None = None, budget: float = 0.01,
             workers: int | None = None, backend: str = "gather",
             plan_exec: str = "stacked", max_greedy_evals: int = 12,
             verbose: bool = False, log=print) -> TuneOutcome:
    """Closed loop: sweep -> frontier -> budget pick -> greedy per-site
    refinement -> final measured plans.

    The budget bounds the *measured* top-1 agreement drop vs the float
    baseline (default 0.01, the paper's accuracy bound).  When no sweep
    point is feasible the outcome falls back to the lowest-drop point with
    ``budget_met=False`` — callers decide whether that is fatal
    (``launch/tune`` does, CI-style).
    """
    grid = grid or default_grid(cfg)
    plan_cache = PlanCache()
    harness = ParityHarness(cfg, params, batches)
    results = run_sweep(cfg, capture, grid, harness,
                        plan_cache=plan_cache, workers=workers,
                        backend=backend, plan_exec=plan_exec,
                        verbose=verbose, log=log)
    ok = [r for r in results if r.ok]
    if not ok:
        raise ValueError(
            "autotune: every sweep point was rejected as degenerate — "
            "capture more batches or widen the grid")
    frontier = pareto_frontier(ok, cost=lambda r: r.cost,
                               drop=lambda r: r.drop)
    default = results[0]
    selected = select_by_budget(frontier, budget,
                                drop=lambda r: r.metrics.top1_drop)
    kinds = [site for site, _ in activation_sites(cfg)]

    if selected is None:
        fallback = min(ok, key=lambda r: r.drop)
        assignment = {k: fallback.point for k in kinds}
        return TuneOutcome(
            results=results, frontier=frontier, default=default,
            selected=None, assignment=assignment,
            plans=build_point_plans(cfg, capture, fallback.point,
                                    plan_cache=plan_cache, workers=workers,
                                    backend=backend, plan_exec=plan_exec),
            metrics=fallback.metrics, cost=fallback.cost, budget=budget,
            budget_met=False, greedy={"evals": 0, "history": []})

    # Greedy per-site refinement: candidates share the selected point's
    # input width (one capture grid -> one w_in per plan build); per-kind
    # cost estimates come from the uniform sweep measurements.
    cands = [r for r in ok
             if (r.point.w_in or capture.w_in)
             == (selected.point.w_in or capture.w_in)]
    cands.sort(key=lambda r: r.drop)     # safest first
    by_point = {r.point: r for r in cands}
    candidates = {k: [r.point for r in cands] for k in kinds}
    # Proposal-ordering estimate: the kind's served cost when the whole
    # network ran at that candidate (accepted moves are re-measured).
    costs = {(k, r.point): float(r.site_costs.get(k, r.cost))
             for k in kinds for r in cands}
    evals = {"n": 0}

    def evaluate(assignment: dict) -> tuple[float, float]:
        evals["n"] += 1
        if len(set(assignment.values())) == 1:
            # uniform assignment == an already-measured sweep point
            r = by_point[next(iter(assignment.values()))]
            return float(r.cost), r.metrics.top1_drop
        plans = build_point_plans(
            cfg, capture, {None: selected.point, **assignment},
            w_in=selected.point.w_in or capture.w_in,
            plan_cache=plan_cache, workers=workers, backend=backend,
            plan_exec=plan_exec)
        res = _measure(plans, harness, selected.point, None, backend,
                       plan_exec)
        return float(res.cost), res.metrics.top1_drop

    start = {k: selected.point for k in kinds}
    assignment, ginfo = greedy_select(
        kinds, candidates, costs, evaluate, budget=budget, start=start,
        max_evals=max_greedy_evals)
    ginfo = {**ginfo, "evals_measured": evals["n"]}
    # ``history`` holds full assignments; keep labels only (JSON-friendly)
    ginfo["history"] = [
        {"assignment": {k: p.label() for k, p in h["assignment"].items()},
         "cost": h["cost"], "drop": h["drop"], "accepted": h["accepted"]}
        for h in ginfo["history"]]

    final_plans = build_point_plans(
        cfg, capture, {None: selected.point, **assignment},
        w_in=selected.point.w_in or capture.w_in, plan_cache=plan_cache,
        workers=workers, backend=backend, plan_exec=plan_exec)
    final_metrics = harness.evaluate(
        final_plans.tables_for_model(backend=backend, plan_exec=plan_exec,
                                     device=harness.device))
    return TuneOutcome(
        results=results, frontier=frontier, default=default,
        selected=selected, assignment=assignment, plans=final_plans,
        metrics=final_metrics, cost=final_plans.total_cost, budget=budget,
        budget_met=final_metrics.top1_drop <= budget, greedy=ginfo)
