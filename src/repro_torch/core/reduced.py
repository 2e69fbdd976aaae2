"""ReducedLUT don't-care merge phase (paper SS4.2-SS4.3).

Starting from the all-care decomposition, try to eliminate unique sub-tables
by rewriting their don't-care entries so they become right-shift
reproducible from other unique sub-tables.  Every elimination must re-home
all dependents of the eliminated sub-table (their don't cares may be used
too); failures roll back.  The *exiguity* parameter caps how many dependents
an elimination candidate may have.  A boolean ``frozen`` mask pins every
entry that participated in a committed transformation.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .similarity import Decomposition

# Below this many candidate rows a thread fan-out costs more than the
# numpy scan it parallelizes.
_MATCH_THREAD_MIN_ROWS = 64

# One long-lived executor per thread count (numpy releases the GIL inside
# the comparison kernels, so plain threads scale on the shared arrays —
# no pickling, unlike the engine's process pool).
_MATCH_POOLS: dict[int, ThreadPoolExecutor] = {}


def _get_match_pool(threads: int) -> ThreadPoolExecutor:
    pool = _MATCH_POOLS.get(threads)
    if pool is None:
        pool = ThreadPoolExecutor(max_workers=threads,
                                  thread_name_prefix="shift-match")
        _MATCH_POOLS[threads] = pool
    return pool


def shutdown_match_pools() -> None:
    """Tear down cached scoring thread pools (tests / shutdown)."""
    for pool in _MATCH_POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _MATCH_POOLS.clear()


def _scan_rows(
    t_vals: np.ndarray,       # (1, 1, n_care)
    care: np.ndarray,
    candidates: np.ndarray,   # (n, M) block
    w_st: int,
) -> tuple[int, int] | None:
    """Serial core: first (row, shift) in a candidate block, row-major."""
    # (n, w_st+1, n_care)
    shifted = candidates[:, None, care] >> np.arange(w_st + 1)[None, :, None]
    ok = (shifted == t_vals).all(axis=2)
    rows, shifts = np.nonzero(ok)
    if rows.size == 0:
        return None
    return int(rows[0]), int(shifts[0])


def _find_shift_match(
    target: np.ndarray,
    target_care: np.ndarray,
    candidates: np.ndarray,
    w_st: int,
    threads: int = 0,
) -> tuple[int, int] | None:
    """First ``(candidate_row, shift)`` whose right-shift matches ``target``
    at all care positions.  ``candidates`` is ``(n, M)``; rows are tried in
    the given order, shifts ascending.  Vectorized over rows and shifts.

    ``threads > 1`` splits the candidate rows into contiguous blocks
    scanned by a shared-memory thread pool; the earliest block with a hit
    wins, so the result is identical to the serial scan (the serial order
    is row-major, and block order preserves row order).
    """
    n = candidates.shape[0]
    if n == 0:
        return None
    care = target_care
    if not care.any():
        return (0, 0)  # fully free: anything generates it
    t_vals = target[care][None, None, :]
    if threads and threads > 1 and n >= max(_MATCH_THREAD_MIN_ROWS,
                                            2 * threads):
        pool = _get_match_pool(threads)
        bounds = np.linspace(0, n, threads + 1).astype(int)
        futures = [
            pool.submit(_scan_rows, t_vals, care,
                        candidates[lo:hi], w_st)
            for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo
        ]
        offsets = [lo for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
        for off, fut in zip(offsets, futures):
            hit = fut.result()
            if hit is not None:
                return hit[0] + off, hit[1]
        return None
    return _scan_rows(t_vals, care, candidates, w_st)


class _Transaction:
    """Provisional edits with rollback (paper: backtracking search)."""

    def __init__(self, d: Decomposition, frozen: np.ndarray):
        self.d = d
        self.frozen = frozen
        self._res_saved: dict[int, np.ndarray] = {}
        self._gen_saved: dict[int, tuple[int, int]] = {}
        self._frozen_rows: list[int] = []

    def set_row(self, j: int, new_res: np.ndarray) -> None:
        if j not in self._res_saved:
            self._res_saved[j] = self.d.res[j].copy()
        self.d.res[j] = new_res

    def reassign(self, j: int, g: int, t: int) -> None:
        if j not in self._gen_saved:
            self._gen_saved[j] = (int(self.d.gen[j]), int(self.d.rsh[j]))
        self.d.gen[j] = g
        self.d.rsh[j] = t

    def freeze(self, j: int) -> None:
        self._frozen_rows.append(j)

    def commit(self) -> None:
        for j in set(self._frozen_rows):
            self.frozen[j] = True

    def rollback(self) -> None:
        for j, row in self._res_saved.items():
            self.d.res[j] = row
        for j, (g, t) in self._gen_saved.items():
            self.d.gen[j] = g
            self.d.rsh[j] = t


def reduce_uniques(d: Decomposition, exiguity: int,
                   match_threads: int = 0) -> int:
    """Run one ReducedLUT merge sweep in place.

    Returns the number of unique sub-tables eliminated.  ``d.res`` rows of
    merged/re-homed sub-tables are rewritten to their reconstruction values
    so Eq. (1) consistency is maintained by construction.
    ``match_threads > 1`` parallelizes the candidate scoring scans
    (bit-identical results; ``CompressConfig.match_threads`` knob).
    """
    frozen = np.zeros_like(d.care)
    eliminated = 0
    deps = d.dep_map()

    def eff_care(j: int) -> np.ndarray:
        return d.care[j] | frozen[j]

    # Candidates with the fewest dependencies first (paper SS4.2).
    order = sorted(d.uniques, key=lambda u: len(deps[u]))
    unique_set = set(d.uniques)
    # Dep-count ranking of the surviving uniques.  ``unique_set`` and
    # ``deps`` only mutate on commit, so the sort is cached between
    # successful merges; dropping ``u`` from a stably-sorted list equals
    # sorting without it, so per-candidate views stay bit-identical to
    # re-sorting from scratch.
    ranked: list[int] | None = None

    for u in order:
        if u not in unique_set:
            continue
        u_deps = deps[u]
        if len(u_deps) > exiguity:
            continue  # exiguity gate (paper SS4.3)
        # Fast reject: with no rewritable entry anywhere in the cluster, a
        # merge would need an exact relation, impossible between uniques.
        if eff_care(u).all() and all(eff_care(j).all() for j in u_deps):
            continue

        # Targets: most-depended-on unique first.
        if ranked is None:
            ranked = sorted(unique_set, key=lambda v: -len(deps[v]))
        targets = [v for v in ranked if v != u]
        if not targets:
            break
        # Invariant across this whole iteration (including the re-homing
        # loop below): set_row only ever touches ``u`` and non-unique
        # dependents, never another unique's row.
        t_rows = d.res[targets]

        hit = _find_shift_match(d.res[u], eff_care(u), t_rows, d.w_st,
                                threads=match_threads)
        if hit is None:
            continue
        row_i, shift = hit
        v = targets[row_i]

        txn = _Transaction(d, frozen)
        txn.set_row(u, d.res[v] >> shift)
        txn.reassign(u, v, shift)
        txn.freeze(u)
        txn.freeze(v)

        ok = True
        rehomed: list[int] = []
        for j in sorted(u_deps):
            hit_j = _find_shift_match(
                d.res[j], eff_care(j), t_rows, d.w_st,
                threads=match_threads,
            )
            if hit_j is None:
                ok = False
                break
            rj, tj = hit_j
            w = targets[rj]
            txn.set_row(j, d.res[w] >> tj)
            txn.reassign(j, w, tj)
            txn.freeze(j)
            txn.freeze(w)
            rehomed.append((j, w))

        if not ok:
            txn.rollback()
            continue

        txn.commit()
        unique_set.remove(u)
        d.uniques.remove(u)
        deps[v].add(u)
        for j, w in rehomed:
            deps[u].discard(j)
            deps[w].add(j)
        deps.pop(u, None)
        eliminated += 1
        ranked = None  # unique_set / dep counts changed

    return eliminated
