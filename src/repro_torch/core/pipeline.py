"""End-to-end table compression flow (paper Fig. 2).

``compress_table`` searches over sub-table sizes ``M`` and higher/lower-bit
splits, runs the all-care decomposition plus (for ReducedLUT) the don't-care
merge sweep for each configuration, scores every candidate with the
analytical P-LUT model, and returns the cheapest plan — falling back to
plain tabulation when decomposition does not pay, exactly as CompressedLUT
does.

Two implementations share this search space:

* the ``*_serial`` functions below — the straightforward reference
  transcription of the paper's loop nest, kept for equivalence testing and
  benchmarking;
* :mod:`repro_torch.core.engine` — the batched/parallel production path that the
  public ``compress_table``/``compress_network`` delegate to.  It is
  bit-identical to the serial reference (see ``tests/test_engine.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .plan import DecomposedPlan, Plan, PlainPlan
from .reduced import reduce_uniques
from .similarity import Decomposition, make_decomposition
from .table import TableSpec


@dataclasses.dataclass
class CompressConfig:
    """Flow configuration.

    ``exiguity is None`` disables the don't-care merge phase entirely, which
    makes the flow exactly CompressedLUT (the paper's primary baseline).
    """

    exiguity: int | None = 250
    m_candidates: tuple[int, ...] | None = None   # None => auto sweep
    lb_candidates: tuple[int, ...] | None = None  # None => 0..w_out-1
    bias_care_only: bool = False                  # beyond-paper option
    merge_sweeps: int = 1                         # beyond-paper: >1 resweeps
    match_threads: int = 0   # >1: threaded shift-match scoring (same result)

    def resolved_m(self, w_in: int) -> tuple[int, ...]:
        if self.m_candidates is not None:
            return tuple(m for m in self.m_candidates if 2 <= m <= 1 << (w_in - 1))
        return tuple(1 << l for l in range(2, w_in - 1))

    def resolved_lb(self, w_out: int) -> tuple[int, ...]:
        if self.lb_candidates is not None:
            return tuple(w for w in self.lb_candidates if 0 <= w < w_out)
        return tuple(range(0, w_out))


def pack_decomposition(
    d: Decomposition,
    *,
    w_in: int,
    w_hb: int,
    w_lb: int,
    lb_values: np.ndarray | None,
    name: str,
) -> DecomposedPlan:
    """Pack a (possibly merge-reduced) decomposition into a plan: unique
    sub-tables concatenated in selection order, index/shift/bias maps, and
    the plain low-bit table when a split is in play."""
    uniques = d.uniques
    pos = {u: k for k, u in enumerate(uniques)}
    t_ust = d.res[uniques].reshape(-1)
    t_idx = np.array([pos[int(d.gen[j])] for j in range(d.n_sub)], dtype=np.int64)
    w_st = int(t_ust.max(initial=0)).bit_length()
    return DecomposedPlan(
        w_in=w_in, w_out=w_hb + w_lb, w_lb=w_lb,
        l=int(np.log2(d.m)), w_st=w_st,
        t_ust=t_ust, t_idx=t_idx, t_rsh=d.rsh.copy(), t_bias=d.bias.copy(),
        t_lb=lb_values, name=name,
    )


def _decompose_hb(
    hb_values: np.ndarray,
    care: np.ndarray,
    w_in: int,
    w_hb: int,
    w_lb: int,
    lb_values: np.ndarray | None,
    m: int,
    cfg: CompressConfig,
    name: str,
) -> DecomposedPlan:
    d = make_decomposition(hb_values, care, m, cfg.bias_care_only)
    if cfg.exiguity is not None:
        for _ in range(max(1, cfg.merge_sweeps)):
            if reduce_uniques(d, cfg.exiguity, cfg.match_threads) == 0:
                break
    return pack_decomposition(
        d, w_in=w_in, w_hb=w_hb, w_lb=w_lb, lb_values=lb_values, name=name
    )


def compress_table_serial(
    spec: TableSpec, cfg: CompressConfig | None = None
) -> Plan:
    """Reference serial search (paper loop nest, one candidate at a time).

    Care entries are always reconstructed bit-exactly (Eq. 3 constraint);
    don't-care entries may change — callers measure accuracy effects.
    """
    cfg = cfg or CompressConfig()
    care = spec.care_mask()
    best: Plan = PlainPlan(
        values=spec.values.copy(), w_in=spec.w_in, w_out=spec.w_out,
        name=spec.name,
    )
    best_cost = best.plut_cost()

    for w_lb in cfg.resolved_lb(spec.w_out):
        w_hb = spec.w_out - w_lb
        hb_values = spec.values >> w_lb
        lb_values = (spec.values & ((1 << w_lb) - 1)) if w_lb > 0 else None
        for m in cfg.resolved_m(spec.w_in):
            plan = _decompose_hb(
                hb_values, care, spec.w_in, w_hb, w_lb, lb_values, m,
                cfg, spec.name,
            )
            cost = plan.plut_cost()
            if cost < best_cost:
                best, best_cost = plan, cost
    return best


def compress_network_serial(
    specs: list[TableSpec], cfg: CompressConfig | None = None,
    verbose: bool = False,
) -> list[Plan]:
    """Reference serial network flow: one table after another."""
    plans = []
    for i, spec in enumerate(specs):
        plan = compress_table_serial(spec, cfg)
        plans.append(plan)
        if verbose:
            base = rom_baseline_cost(spec)
            print(
                f"  [{i + 1}/{len(specs)}] {spec.name}: {plan.kind} "
                f"cost={plan.plut_cost()} (plain={base})"
            )
    return plans


def compress_table(spec: TableSpec, cfg: CompressConfig | None = None) -> Plan:
    """Compress one L-LUT; returns the cheapest plan under the cost model.

    Delegates to the batched engine (bit-identical to
    :func:`compress_table_serial`, measurably faster).
    """
    from .engine import compress_table as _engine_compress_table

    return _engine_compress_table(spec, cfg)


def compress_network(
    specs: list[TableSpec], cfg: CompressConfig | None = None,
    verbose: bool = False, workers: int | None = None,
) -> list[Plan]:
    """Compress every L-LUT of a network independently (paper flow).

    ``workers > 1`` fans tables out over a process pool; see
    :func:`repro_torch.core.engine.compress_network_report` for the structured
    per-table report variant.
    """
    from .engine import compress_network as _engine_compress_network

    return _engine_compress_network(specs, cfg, workers=workers, verbose=verbose)


def rom_baseline_cost(spec: TableSpec) -> int:
    return PlainPlan(spec.values, spec.w_in, spec.w_out).plut_cost()


def verify_care_exact(spec: TableSpec, plan: Plan) -> bool:
    """Eq. (3): the plan must reproduce every care entry bit-exactly."""
    rec = plan.reconstruct()
    care = spec.care_mask()
    return bool(np.array_equal(rec[care], spec.values[care]))
