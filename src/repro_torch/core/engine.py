"""Parallel, batched table-compression engine (paper Fig. 2 fast path).

The paper's flow searches every ``(w_lb, M)`` configuration of every L-LUT
independently; :mod:`pipeline` keeps the straightforward serial reference.
This module is the production path, bit-identical to it by construction
(enforced by ``tests/test_engine.py``), with three speedups:

1. **Hoisted decomposition prefix** — the per-``w_lb`` high/low-bit splits
   are materialized once as a ``(n_lb, 2**w_in)`` stack, and the
   per-``M`` residual/bias/care construction runs once per ``(table, M)``
   over that whole stack (:func:`similarity.split_residualize_batch`)
   instead of once per ``(w_lb, M)`` pair in the inner loop.
2. **Batched candidate scoring** — candidates are reduced to summary
   statistics (unique count, packed residual width, shift/bias widths)
   and scored in one vectorized pass
   (:func:`cost_model.decomposed_plut_cost_batch`); only the winning
   candidate is packed into a full :class:`~repro_torch.core.plan.DecomposedPlan`.
3. **Process-parallel networks** — :func:`compress_network_report` fans
   tables out over a ``ProcessPoolExecutor`` (``workers`` knob, spawn
   context so workers import nothing but numpy) with deterministic result
   order, returning a structured :class:`CompressReport`.

Tie-breaking matches the serial reference exactly: candidates are scored
in the serial enumeration order (``w_lb`` outer, ``M`` inner), the first
candidate attaining the global minimum wins, and a tie with the plain
tabulation goes to plain.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .bitutils import bits_for_count, bits_for_value
from .cost_model import decomposed_plut_cost_batch
from .pipeline import CompressConfig, pack_decomposition
from .plan import Plan, PlainPlan
from .reduced import reduce_uniques
from .similarity import Decomposition, initial_selection, split_residualize_batch
from .table import TableSpec


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TableReport:
    """Per-table outcome of the compression search."""

    name: str
    kind: str                # "plain" | "decomposed"
    cost: int                # winning plan's analytical P-LUT cost
    plain_cost: int          # raw-tabulation cost of the same table
    w_lb: int                # lower-bit split of the winner (0 for plain)
    m: int | None            # sub-table length of the winner (None for plain)
    eliminated: int          # unique sub-tables removed by the merge phase
    n_candidates: int        # (w_lb, M) configurations scored
    seconds: float

    @property
    def saved_frac(self) -> float:
        if self.plain_cost <= 0:
            return 0.0
        return 1.0 - self.cost / self.plain_cost

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CompressReport:
    """Structured result of :func:`compress_network_report`.

    ``plans[i]`` and ``tables[i]`` describe ``specs[i]`` — result order is
    input order regardless of ``workers``.  When duplicate-table sharing is
    on (the default), identical ``(values, care)`` tables are compressed
    once and the shared result is cloned per input site: ``n_unique``
    counts the distinct searches actually run and ``dedup_hits`` the input
    tables served from a shared result.
    """

    plans: list[Plan]
    tables: list[TableReport]
    workers: int
    seconds: float           # wall clock for the whole network
    n_unique: int | None = None   # distinct (values, care) tables searched
    dedup_hits: int = 0           # inputs that reused a shared search
    cache_hits: int = 0           # unique tables served from a PlanCache

    @property
    def total_cost(self) -> int:
        return sum(t.cost for t in self.tables)

    @property
    def total_plain_cost(self) -> int:
        return sum(t.plain_cost for t in self.tables)

    @property
    def saved_frac(self) -> float:
        base = self.total_plain_cost
        return 1.0 - self.total_cost / base if base else 0.0

    @property
    def n_decomposed(self) -> int:
        return sum(1 for t in self.tables if t.kind == "decomposed")

    @property
    def total_eliminated(self) -> int:
        return sum(t.eliminated for t in self.tables)

    @property
    def dedup_rate(self) -> float:
        """Fraction of input tables served by a shared duplicate result."""
        n = len(self.tables)
        return self.dedup_hits / n if n else 0.0

    def summary(self) -> str:
        n = len(self.tables)
        msg = (
            f"{n} tables in {self.seconds:.2f}s (workers={self.workers}): "
            f"{self.total_cost} P-LUTs vs {self.total_plain_cost} plain "
            f"({self.saved_frac:.1%} saved); "
            f"{self.n_decomposed} decomposed / {n - self.n_decomposed} plain; "
            f"{self.total_eliminated} sub-tables eliminated"
        )
        if self.n_unique is not None and self.dedup_hits:
            msg += (f"; dedupe: {self.n_unique} unique, "
                    f"{self.dedup_hits} shared ({self.dedup_rate:.0%} hit-rate)")
        if self.cache_hits:
            msg += f"; plan-cache: {self.cache_hits} hits"
        return msg

    def table_lines(self) -> list[str]:
        return [
            f"{t.name}: {t.kind} cost={t.cost} (plain={t.plain_cost}, "
            f"w_lb={t.w_lb}, M={t.m}, elim={t.eliminated}, "
            f"{t.seconds * 1e3:.0f}ms)"
            for t in self.tables
        ]

    def to_rows(self) -> list[dict]:
        return [t.to_dict() for t in self.tables]


# ---------------------------------------------------------------------------
# Single-table search
# ---------------------------------------------------------------------------
def _compress_one(spec: TableSpec, cfg: CompressConfig) -> tuple[Plan, TableReport]:
    t0 = time.perf_counter()
    care = spec.care_mask()
    plain = PlainPlan(
        values=spec.values.copy(), w_in=spec.w_in, w_out=spec.w_out,
        name=spec.name,
    )
    plain_cost = plain.plut_cost()

    lbs = cfg.resolved_lb(spec.w_out)
    ms = cfg.resolved_m(spec.w_in)
    n_cand = len(lbs) * len(ms)
    if n_cand == 0:
        report = TableReport(
            name=spec.name, kind="plain", cost=plain_cost,
            plain_cost=plain_cost, w_lb=0, m=None, eliminated=0,
            n_candidates=0, seconds=time.perf_counter() - t0,
        )
        return plain, report

    # (1) hoisted high/low-bit split: one stack for every w_lb candidate.
    lb_arr = np.asarray(lbs, dtype=np.int64)
    hb_all = spec.values[None, :] >> lb_arr[:, None]

    # Candidate stats in serial enumeration order (w_lb outer, M inner).
    l_s = np.zeros(n_cand, np.int64)
    w_lb_s = np.zeros(n_cand, np.int64)
    w_st_s = np.zeros(n_cand, np.int64)
    idx_bits_s = np.zeros(n_cand, np.int64)
    rsh_bits_s = np.zeros(n_cand, np.int64)
    bias_bits_s = np.zeros(n_cand, np.int64)
    states: list[tuple[Decomposition, int] | None] = [None] * n_cand

    for mi, m in enumerate(ms):
        # (1b) residual/bias/care construction once per (table, M),
        # shared across every w_lb candidate.
        res_all, bias_all, care2d = split_residualize_batch(
            hb_all, care, m, cfg.bias_care_only
        )
        for li, w_lb in enumerate(lbs):
            res = res_all[li]
            w_st = bits_for_value(int(res.max(initial=0)))
            gen, rsh, uniques = initial_selection(res, w_st)
            d = Decomposition(
                res=res, bias=bias_all[li], care=care2d, gen=gen, rsh=rsh,
                uniques=uniques, w_st=w_st,
            )
            eliminated = 0
            if cfg.exiguity is not None:
                for _ in range(max(1, cfg.merge_sweeps)):
                    e = reduce_uniques(d, cfg.exiguity, cfg.match_threads)
                    eliminated += e
                    if e == 0:
                        break
            k = li * len(ms) + mi
            l_s[k] = int(np.log2(m))
            w_lb_s[k] = w_lb
            w_st_s[k] = bits_for_value(int(d.res[d.uniques].max(initial=0)))
            idx_bits_s[k] = bits_for_count(len(d.uniques))
            rsh_bits_s[k] = bits_for_value(int(d.rsh.max(initial=0)))
            bias_bits_s[k] = bits_for_value(int(d.bias.max(initial=0)))
            states[k] = (d, eliminated)

    # (2) one vectorized scoring pass over all candidates.
    costs = decomposed_plut_cost_batch(
        w_in=spec.w_in, w_out=spec.w_out, l=l_s, w_lb=w_lb_s, w_st=w_st_s,
        idx_bits=idx_bits_s, rsh_bits=rsh_bits_s, bias_bits=bias_bits_s,
    )
    best = int(np.argmin(costs))  # first min == serial tie-break order
    if int(costs[best]) >= plain_cost:
        report = TableReport(
            name=spec.name, kind="plain", cost=plain_cost,
            plain_cost=plain_cost, w_lb=0, m=None, eliminated=0,
            n_candidates=n_cand, seconds=time.perf_counter() - t0,
        )
        return plain, report

    d, eliminated = states[best]
    w_lb = int(w_lb_s[best])
    lb_values = (
        (spec.values & ((1 << w_lb) - 1)) if w_lb > 0 else None
    )
    plan = pack_decomposition(
        d, w_in=spec.w_in, w_hb=spec.w_out - w_lb, w_lb=w_lb,
        lb_values=lb_values, name=spec.name,
    )
    report = TableReport(
        name=spec.name, kind="decomposed", cost=int(costs[best]),
        plain_cost=plain_cost, w_lb=w_lb, m=1 << int(l_s[best]),
        eliminated=eliminated, n_candidates=n_cand,
        seconds=time.perf_counter() - t0,
    )
    return plan, report


def compress_table(spec: TableSpec, cfg: CompressConfig | None = None) -> Plan:
    """Engine single-table search; bit-identical to the serial reference."""
    plan, _ = _compress_one(spec, cfg or CompressConfig())
    return plan


# ---------------------------------------------------------------------------
# Network-level parallelism
# ---------------------------------------------------------------------------
def _pool_worker(args: tuple[TableSpec, CompressConfig]):
    spec, cfg = args
    return _compress_one(spec, cfg)


# One long-lived executor per worker count: compression runs many
# network-sized batches per session (method x exiguity x model in the
# benchmarks), and spawn startup would otherwise dominate small batches.
_POOLS: dict[int, ProcessPoolExecutor] = {}


def _get_pool(workers: int) -> ProcessPoolExecutor:
    pool = _POOLS.get(workers)
    if pool is None:
        ctx = multiprocessing.get_context("spawn")
        pool = ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
        _POOLS[workers] = pool
    return pool


def shutdown_pools() -> None:
    """Tear down cached worker pools (tests / interpreter shutdown)."""
    for pool in _POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()


def _warm_task(delay: float) -> int:
    # Unpickling this function in a fresh worker imports repro_torch.core (and
    # numpy); the sleep keeps early finishers busy so the executor's
    # on-demand spawning actually brings up every worker, not just one.
    if delay:
        time.sleep(delay)
    return 0


def warm_pool(workers: int) -> None:
    """Pre-spawn a pool so later calls (or timing runs) pay no startup."""
    if workers > 1:
        pool = _get_pool(workers)
        futures = [pool.submit(_warm_task, 0.2) for _ in range(workers)]
        for f in futures:
            f.result()


def default_workers() -> int:
    """Worker count when callers don't pass one: the
    ``REPRO_COMPRESS_WORKERS`` env var, else 1 (in-process serial) so
    library callers never pay process-pool startup unless asked to.
    """
    env = os.environ.get("REPRO_COMPRESS_WORKERS")
    if env:
        return max(1, int(env))
    return 1


def _spec_key(spec: TableSpec) -> tuple:
    """Content identity of a table: two specs with the same key compress to
    bit-identical plans (the search never looks at ``name``)."""
    return (spec.w_in, spec.w_out, spec.values.tobytes(),
            spec.care_mask().tobytes())


class PlanCache:
    """Cross-call compression-result cache keyed by table content.

    The autotune sweep (the autotune sweep, not yet ported) compresses the same network
    many times with different don't-care knobs; any ``(values, care,
    w_in, w_out)`` spec that recurs across sweep points — unchanged masks
    for an insensitive site, the default point re-evaluated per assignment
    — is served from here instead of re-searched.  Results are exact
    clones of the original search (the search is deterministic in the
    spec content), renamed per requesting site, so cached and fresh plans
    are bit-identical.

    The cache is keyed on table content but NOT on :class:`CompressConfig`
    — callers must use one cache per engine configuration (the sweep
    holds one per run).
    """

    def __init__(self) -> None:
        self._store: dict[tuple, tuple[Plan, TableReport]] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def get(self, spec: TableSpec) -> tuple[Plan, TableReport] | None:
        hit = self._store.get(_spec_key(spec))
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        plan, rep = hit
        return (dataclasses.replace(plan, name=spec.name),
                dataclasses.replace(rep, name=spec.name, seconds=0.0))

    def put(self, spec: TableSpec, plan: Plan, report: TableReport) -> None:
        self._store[_spec_key(spec)] = (plan, report)

    def summary(self) -> str:
        return (f"plan-cache[{len(self._store)} entries, "
                f"{self.hits} hits / {self.misses} misses]")


def compress_network_report(
    specs: list[TableSpec],
    cfg: CompressConfig | None = None,
    workers: int | None = None,
    verbose: bool = False,
    dedupe: bool = True,
    cache: PlanCache | None = None,
) -> CompressReport:
    """Compress every L-LUT of a network; tables are independent (paper
    flow), so they fan out over a process pool when ``workers > 1``.

    Result order is input order and the per-table plans are bit-identical
    to ``workers=1`` (each table's search is self-contained and
    deterministic).  ``dedupe=True`` (default) compresses each distinct
    ``(values, care)`` table once and shares the result across duplicate
    sites — networks of repeated layers pay one search per unique table;
    duplicate sites get a renamed clone of the shared plan and a
    ``seconds=0`` table report, and the hit-rate lands in the report's
    ``n_unique``/``dedup_hits``/``dedup_rate``.

    Pools use the ``spawn`` context (workers import only
    :mod:`repro_torch.core` — pure numpy, never the caller's JAX state) and are
    cached per worker count so repeated network-sized batches pay startup
    once; use :func:`warm_pool` to pre-pay it and :func:`shutdown_pools`
    to tear them down.  Pool failures fall back to the in-process path.

    ``cache`` (a :class:`PlanCache`) additionally shares results *across
    calls*: unique tables whose content key is already cached skip the
    search entirely (``report.cache_hits``) and fresh searches are
    inserted — the autotune sweep's repeated-spec fast path.
    """
    cfg = cfg or CompressConfig()
    workers = default_workers() if workers is None else max(1, workers)
    t0 = time.perf_counter()

    # Duplicate-table sharing: first occurrence of each content key is the
    # representative that actually runs the search.
    if dedupe:
        key_of: list[tuple] = [_spec_key(s) for s in specs]
        rep_index: dict[tuple, int] = {}
        uniq_specs: list[TableSpec] = []
        for i, (spec, key) in enumerate(zip(specs, key_of)):
            if key not in rep_index:
                rep_index[key] = len(uniq_specs)
                uniq_specs.append(spec)
    else:
        key_of = list(range(len(specs)))  # every spec its own key
        rep_index = {i: i for i in range(len(specs))}
        uniq_specs = list(specs)

    # Cross-call cache: serve already-searched unique tables, run the rest.
    uniq_results: list[tuple[Plan, TableReport] | None]
    uniq_results = [None] * len(uniq_specs)
    cache_hits = 0
    pending = list(range(len(uniq_specs)))
    if cache is not None:
        pending = []
        for i, spec in enumerate(uniq_specs):
            hit = cache.get(spec)
            if hit is not None:
                uniq_results[i] = hit
                cache_hits += 1
            else:
                pending.append(i)

    jobs = [(uniq_specs[i], cfg) for i in pending]
    if workers == 1 or len(jobs) < 2:
        workers = 1
        run_results = [_compress_one(spec, cfg) for spec, cfg in jobs]
    else:
        chunk = max(1, len(jobs) // (workers * 4))
        try:
            pool = _get_pool(workers)
            run_results = list(pool.map(_pool_worker, jobs, chunksize=chunk))
        except Exception:
            # Broken/unpicklable pool state: drop the cached pool and fall
            # back to the in-process path rather than failing the caller.
            shutdown_pools()
            workers = 1
            run_results = [_compress_one(spec, cfg) for spec, cfg in jobs]
    for i, res in zip(pending, run_results):
        uniq_results[i] = res
        if cache is not None:
            cache.put(uniq_specs[i], *res)

    plans: list[Plan] = []
    tables: list[TableReport] = []
    served = [False] * len(uniq_specs)
    dedup_hits = 0
    for spec, key in zip(specs, key_of):
        u = rep_index[key]
        plan, rep = uniq_results[u]
        if not served[u]:
            # representative == first input spec with this key, so its
            # plan/report already carry the right name
            served[u] = True
        else:
            dedup_hits += 1
            plan = dataclasses.replace(plan, name=spec.name)
            rep = dataclasses.replace(rep, name=spec.name, seconds=0.0)
        plans.append(plan)
        tables.append(rep)

    report = CompressReport(
        plans=plans, tables=tables, workers=workers,
        seconds=time.perf_counter() - t0,
        n_unique=len(uniq_specs), dedup_hits=dedup_hits,
        cache_hits=cache_hits,
    )
    if verbose:
        for line in report.table_lines():
            print(f"  {line}")
        print(f"  {report.summary()}")
    return report


def compress_network(
    specs: list[TableSpec],
    cfg: CompressConfig | None = None,
    workers: int | None = None,
    verbose: bool = False,
) -> list[Plan]:
    """Plans only (back-compat shim over :func:`compress_network_report`)."""
    return compress_network_report(specs, cfg, workers, verbose).plans
