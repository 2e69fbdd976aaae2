"""CompressedLUT-style self-similarity analysis (paper SS2.2.2, Eq. 4).

This module implements the *all-care* decomposition phase that ReducedLUT
starts from: split a table into sub-tables, extract per-sub-table bias,
build the right-shift similarity relation, and greedily select unique
sub-tables by descending similarity-vector score.

The similarity relation ``SM[i, j] = 1  iff  exists t: ST_i >> t == ST_j``
is computed with exact-byte hashing over duplicate groups instead of the
dense ``n^2`` matrix — identical semantics, near-linear cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .bitutils import bits_for_value


@dataclasses.dataclass
class Decomposition:
    """All-care decomposition state shared with the ReducedLUT merge phase."""

    res: np.ndarray      # (n_sub, M) int64 residuals (sub-table values - bias)
    bias: np.ndarray     # (n_sub,) int64 per-sub-table bias
    care: np.ndarray     # (n_sub, M) bool care mask over residual entries
    gen: np.ndarray      # (n_sub,) int64: index of generating sub-table
    rsh: np.ndarray      # (n_sub,) int64: right shift applied to generator
    uniques: list[int]   # generating sub-table ids, selection order
    w_st: int            # residual bit-width

    @property
    def n_sub(self) -> int:
        return self.res.shape[0]

    @property
    def m(self) -> int:
        return self.res.shape[1]

    def dep_map(self) -> dict[int, set[int]]:
        deps: dict[int, set[int]] = {u: set() for u in self.uniques}
        for j in range(self.n_sub):
            g = int(self.gen[j])
            if g != j:
                deps[g].add(j)
        return deps

    def verify(self) -> None:
        """Invariant: every sub-table is its generator right-shifted."""
        for j in range(self.n_sub):
            g, t = int(self.gen[j]), int(self.rsh[j])
            if not np.array_equal(self.res[g] >> t, self.res[j]):
                raise AssertionError(f"sub-table {j} != gen {g} >> {t}")
            if g != j and g not in self.uniques:
                raise AssertionError(f"generator {g} of {j} is not unique")


def split_residualize(
    values: np.ndarray,
    care: np.ndarray,
    m: int,
    bias_care_only: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a flat table into ``M``-entry sub-tables and extract biases.

    Returns ``(res, bias, care2d)``.  ``bias_care_only`` bases the bias on
    care entries only (beyond-paper option; default matches CompressedLUT,
    which uses the plain per-sub-table minimum).
    """
    res, bias, care2d = split_residualize_batch(
        values[None, :], care, m, bias_care_only
    )
    return res[0], bias[0], care2d


def split_residualize_batch(
    hb_values: np.ndarray,
    care: np.ndarray,
    m: int,
    bias_care_only: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched :func:`split_residualize` over a stack of high-bit tables.

    ``hb_values`` is ``(n_cand, 2**w_in)`` — one row per ``w_lb`` candidate
    (the table's values right-shifted by each candidate split).  The care
    mask is shared by every candidate, so its ``(n_sub, M)`` reshape and
    the residual/bias extraction happen once here instead of once per
    ``(w_lb, M)`` pair in the search's inner loop.

    Returns ``(res, bias, care2d)`` where ``res`` is ``(n_cand, n_sub, M)``
    and ``bias`` is ``(n_cand, n_sub)``; slice ``i`` is bit-identical to
    ``split_residualize(hb_values[i], care, m, bias_care_only)``.
    """
    n = hb_values.shape[1]
    if n % m != 0:
        raise ValueError(f"table size {n} not divisible by sub-table size {m}")
    sub = hb_values.reshape(hb_values.shape[0], -1, m).astype(np.int64)
    care2d = care.reshape(-1, m)
    if bias_care_only:
        masked = np.where(care2d[None], sub, np.iinfo(np.int64).max)
        bias = masked.min(axis=2)
        # all-don't-care sub-table: bias 0
        bias = np.where(care2d.any(axis=1)[None], bias, 0)
    else:
        bias = sub.min(axis=2)
    res = sub - bias[:, :, None]
    if bias_care_only:
        # don't-care residuals may go negative; they are free anyway — clamp.
        res = np.maximum(res, 0)
    return res, bias.astype(np.int64), care2d


def _row_key(row: np.ndarray) -> bytes:
    return row.astype(np.int64).tobytes()


def initial_selection(res: np.ndarray, w_st: int) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Greedy unique-sub-table selection treating every entry as care.

    Implements paper SS4.2: build SM/SV, repeatedly pick the sub-table with
    the highest similarity-vector score, assign everything it generates to
    it, zero the affected rows/columns, recompute SV, repeat.

    Returns ``(gen, rsh, uniques)`` where ``gen[j]``/``rsh[j]`` reconstruct
    sub-table ``j`` as ``res[gen[j]] >> rsh[j]``.
    """
    n_sub = res.shape[0]
    gen = np.arange(n_sub, dtype=np.int64)
    rsh = np.zeros(n_sub, dtype=np.int64)

    # --- group exact duplicates -------------------------------------------
    groups: dict[bytes, list[int]] = {}
    for i in range(n_sub):
        groups.setdefault(_row_key(res[i]), []).append(i)
    reps = [members[0] for members in groups.values()]
    rep_of_key = {key: members[0] for key, members in groups.items()}
    members_of = {members[0]: members for members in groups.values()}
    rep_index = {r: k for k, r in enumerate(reps)}
    n_rep = len(reps)
    count = np.array([len(members_of[r]) for r in reps], dtype=np.int64)

    # --- shift-similarity edges over representatives ----------------------
    # edge i -> (j, t): rep_i >> t reproduces rep_j (t >= 1; t = 0 handled
    # by duplicate grouping).
    out_edges: list[dict[int, int]] = [dict() for _ in range(n_rep)]
    in_edges: list[set[int]] = [set() for _ in range(n_rep)]
    for k, r in enumerate(reps):
        row = res[r]
        for t in range(1, w_st + 1):
            key = _row_key(row >> t)
            j_rep = rep_of_key.get(key)
            if j_rep is None:
                continue
            jk = rep_index[j_rep]
            if jk == k:
                continue  # self-similar under shift (e.g. all-zero) — skip
            if jk not in out_edges[k]:
                out_edges[k][jk] = t
                in_edges[jk].add(k)

    # --- greedy selection by similarity-vector score -----------------------
    # SV[k] = number of actual sub-tables rep k can generate (its own
    # duplicates plus every member of every shift-reachable group).
    sv = count.copy()
    for k in range(n_rep):
        for jk in out_edges[k]:
            sv[k] += count[jk]
    alive = np.ones(n_rep, dtype=bool)
    uniques: list[int] = []

    def _kill(k: int) -> None:
        alive[k] = False
        for ik in in_edges[k]:
            if alive[ik]:
                sv[ik] -= count[k]
        count[k] = 0

    while alive.any():
        k = int(np.argmax(np.where(alive, sv, -1)))
        u = reps[k]
        uniques.append(u)
        for dup in members_of[u]:
            gen[dup] = u
            rsh[dup] = 0
        captured = [jk for jk in out_edges[k] if alive[jk]]
        _kill(k)
        for jk in captured:
            t = out_edges[k][jk]
            for member in members_of[reps[jk]]:
                gen[member] = u
                rsh[member] = t
            _kill(jk)

    return gen, rsh, uniques


def make_decomposition(
    values: np.ndarray,
    care: np.ndarray,
    m: int,
    bias_care_only: bool = False,
) -> Decomposition:
    """Full all-care decomposition of a flat table at sub-table size ``m``."""
    res, bias, care2d = split_residualize(values, care, m, bias_care_only)
    w_st = bits_for_value(int(res.max(initial=0)))
    gen, rsh, uniques = initial_selection(res, w_st)
    return Decomposition(
        res=res, bias=bias, care=care2d, gen=gen, rsh=rsh,
        uniques=uniques, w_st=w_st,
    )
