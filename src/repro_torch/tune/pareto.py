"""Pareto-frontier extraction and budgeted per-site knob selection (own
copy of the reference's ``tune/pareto.py``, pure Python: the same inputs
give the same outputs).

Two pure decision procedures, deliberately free of model/serving state so
they are property-testable:

* :func:`pareto_frontier` — the non-dominated set over (compression cost,
  quality drop), sorted by cost: the repo's analogue of the paper's
  Table 2 frontier.
* :func:`greedy_select` — per-site knob assignment maximizing compression
  subject to an accuracy budget.  One global knob is provably no better:
  sites differ in sensitivity, and any feasible global point is also a
  feasible uniform assignment the greedy search starts from or dominates.
  Moves are proposed cheapest-estimated-savings-first and every accepted
  move is *re-measured* (the ``evaluate`` callback returns the real
  served quality), so the selector can never return an assignment whose
  measured drop exceeds the budget.
"""
from __future__ import annotations

from typing import Callable, Hashable, Mapping, Sequence


def pareto_frontier(items: Sequence, *, cost: Callable,
                    drop: Callable) -> list:
    """Non-dominated subset of ``items``, sorted by ``cost`` ascending.

    ``cost(item)`` returns a number; ``drop(item)`` a number or a
    lexicographic tuple (e.g. ``(top1_drop, kl, ppl_delta)`` so exact
    top-1 ties still order by distributional drift).  Along the returned
    frontier cost is non-decreasing and drop strictly decreasing — paying
    more P-LUTs must buy measurably better quality.
    """
    ordered = sorted(items, key=lambda r: (cost(r), drop(r)))
    out: list = []
    best = None
    for r in ordered:
        d = drop(r)
        if best is None or d < best:
            out.append(r)
            best = d
    return out


def select_by_budget(frontier: Sequence, budget: float, *,
                     drop: Callable):
    """Cheapest frontier point whose measured drop is within ``budget``
    (``drop`` here returns the budgeted scalar, e.g. ``top1_drop``);
    ``None`` when no point qualifies.  Frontier drop decreases with cost,
    so the first qualifying point in cost order is the cheapest one."""
    for r in frontier:
        if drop(r) <= budget:
            return r
    return None


def greedy_select(
    kinds: Sequence[Hashable],
    candidates: Mapping[Hashable, Sequence[Hashable]],
    costs: Mapping[tuple, float],
    evaluate: Callable[[dict], tuple[float, float]],
    *,
    budget: float,
    start: Mapping[Hashable, Hashable] | None = None,
    max_evals: int = 32,
) -> tuple[dict, dict]:
    """Greedy per-site knob selection under an accuracy budget.

    ``kinds``: selection units (site kinds).  ``candidates[kind]``: that
    kind's knob options, safest first (index 0 seeds the assignment when
    no ``start`` is given).  ``costs[(kind, cand)]``: estimated per-kind
    compression cost used only to *order* proposals.  ``evaluate``
    (assignment -> ``(measured_cost, measured_drop)``) is the ground
    truth; it is called on the start and on every proposed move, and a
    move is kept only if its measured drop stays within ``budget`` and
    its measured cost improves.

    Returns ``(assignment, info)`` where ``info`` carries the measured
    ``(cost, drop)`` of the returned assignment, the evaluation count and
    the accepted-move history.  Raises ``ValueError`` if the starting
    assignment already violates the budget.
    """
    assignment = dict(start) if start is not None else {
        k: candidates[k][0] for k in kinds}
    cost0, drop0 = evaluate(assignment)
    evals = 1
    if drop0 > budget:
        raise ValueError(
            f"greedy_select: starting assignment violates the accuracy "
            f"budget (measured drop {drop0} > {budget}) — start from a "
            f"budget-feasible frontier point")
    best_cost, best_drop = cost0, drop0
    history = [{"assignment": dict(assignment), "cost": cost0,
                "drop": drop0, "accepted": True}]
    improved = True
    while improved and evals < max_evals:
        improved = False
        moves = []
        for k in kinds:
            cur = costs[(k, assignment[k])]
            for cand in candidates[k]:
                if cand == assignment[k]:
                    continue
                est = costs[(k, cand)]
                if est < cur:
                    moves.append((est - cur, k, cand))
        moves.sort(key=lambda m: m[0])
        for _, k, cand in moves:
            if evals >= max_evals:
                break
            trial = {**assignment, k: cand}
            c, d = evaluate(trial)
            evals += 1
            ok = d <= budget and c < best_cost
            history.append({"assignment": dict(trial), "cost": c,
                            "drop": d, "accepted": ok})
            if ok:
                assignment = trial
                best_cost, best_drop = c, d
                improved = True
                break
    return assignment, {"cost": best_cost, "drop": best_drop,
                        "evals": evals, "history": history}
