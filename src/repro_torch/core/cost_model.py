"""Analytical P-LUT (6-input physical LUT) area model.

The paper reports Vivado-synthesized P-LUT counts; Vivado is unavailable
offline, so every benchmark in this repo uses the analytical estimator below.
It models a ``2^q x w``-bit ROM mapped onto 6-input LUTs the way Vivado maps
raw ``case`` tabulations:

* ``q <= 6``: one LUT per output bit.
* ``q > 6``: ``2^(q-6)`` leaf LUTs per output bit, one free 4:1 combining
  level (dedicated F7/F8 muxes in a slice), then a 4:1-mux tree built from
  LUT6s (a LUT6 implements one 4:1 mux) down to a single output.

Arithmetic glue produced by the decomposition (Eq. 1) is also charged:
an adder costs one LUT per result bit (carry chains make this nearly exact)
and a right barrel shifter costs one LUT per data bit per mux stage, where a
LUT6 covers two stages (4:1 mux = 2 select bits).

The model intentionally over-estimates absolute Vivado numbers (Vivado's
logic optimizer exploits function structure that plain tabulation cost
cannot see) but preserves the *relative* ordering that the paper's claims
are about; see DESIGN.md SS2.
"""
from __future__ import annotations

import math

import numpy as np


def rom_plut_cost(q: int, w: int) -> int:
    """P-LUTs to implement a ``2^q``-entry, ``w``-bit-wide ROM."""
    if w <= 0 or q < 0:
        return 0
    if q <= 6:
        return w
    leaves = 2 ** (q - 6)
    total = leaves
    fanin = math.ceil(leaves / 4)  # free F7/F8 level per slice
    while fanin > 1:
        muxes = math.ceil(fanin / 4)
        total += muxes
        fanin = muxes
    if fanin == 1 and leaves > 4:
        pass  # final mux already counted by the loop
    return w * total


def adder_plut_cost(w: int) -> int:
    """P-LUTs for a ``w``-bit adder (carry-chain mapping: 1 LUT/bit)."""
    return max(0, w)


def shifter_plut_cost(data_bits: int, shift_bits: int) -> int:
    """P-LUTs for a right barrel shifter.

    ``shift_bits`` select-bit stages; each LUT6 absorbs a 4:1 mux
    (two stages) per data bit.
    """
    if shift_bits <= 0 or data_bits <= 0:
        return 0
    return data_bits * math.ceil(shift_bits / 2)


def concat_plut_cost() -> int:
    """Bit concatenation is wiring on an FPGA: free."""
    return 0


# ---------------------------------------------------------------------------
# Batched candidate scoring (engine fast path)
# ---------------------------------------------------------------------------
# The compression search scores every (w_lb, M) candidate of every table;
# the vectorized forms below evaluate all candidates of a table in one
# numpy pass from summary statistics, so the engine only materializes the
# winning plan.  Each function is the exact elementwise extension of its
# scalar counterpart above (enforced by tests/test_engine.py).

def rom_plut_cost_batch(q: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Vectorized :func:`rom_plut_cost` over int arrays ``q``/``w``."""
    q = np.asarray(q, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    q, w = np.broadcast_arrays(q, w)
    leaves = np.where(q > 6, 1 << np.maximum(q - 6, 0), 1).astype(np.int64)
    total = leaves.copy()
    fanin = -(-leaves // 4)  # ceil div: free F7/F8 level per slice
    while (fanin > 1).any():
        muxes = -(-fanin // 4)
        total = np.where(fanin > 1, total + muxes, total)
        fanin = np.where(fanin > 1, muxes, fanin)
    deep = w * total
    out = np.where(q <= 6, w, deep)
    return np.where((w <= 0) | (q < 0), 0, out)


def adder_plut_cost_batch(w: np.ndarray) -> np.ndarray:
    """Vectorized :func:`adder_plut_cost`."""
    return np.maximum(0, np.asarray(w, dtype=np.int64))


def shifter_plut_cost_batch(
    data_bits: np.ndarray, shift_bits: np.ndarray
) -> np.ndarray:
    """Vectorized :func:`shifter_plut_cost`."""
    data_bits = np.asarray(data_bits, dtype=np.int64)
    shift_bits = np.asarray(shift_bits, dtype=np.int64)
    cost = data_bits * -(-shift_bits // 2)
    return np.where((shift_bits <= 0) | (data_bits <= 0), 0, cost)


def decomposed_plut_cost_batch(
    *,
    w_in: int,
    w_out: int,
    l: np.ndarray,
    w_lb: np.ndarray,
    w_st: np.ndarray,
    idx_bits: np.ndarray,
    rsh_bits: np.ndarray,
    bias_bits: np.ndarray,
) -> np.ndarray:
    """Total P-LUT cost of decomposed-plan candidates from summary stats.

    Mirrors ``DecomposedPlan.component_costs()`` without building plans:
    t_ust + t_idx + t_rsh + t_bias + t_lb ROMs, the barrel shifter, and
    the bias adder (charged only when any bias bit is nonzero).
    """
    l = np.asarray(l, dtype=np.int64)
    w_lb = np.asarray(w_lb, dtype=np.int64)
    q_hb = w_in - l
    w_hb = w_out - w_lb
    return (
        rom_plut_cost_batch(idx_bits + l, w_st)
        + rom_plut_cost_batch(q_hb, idx_bits)
        + rom_plut_cost_batch(q_hb, rsh_bits)
        + rom_plut_cost_batch(q_hb, bias_bits)
        + rom_plut_cost_batch(np.full_like(l, w_in), w_lb)
        + shifter_plut_cost_batch(w_st, rsh_bits)
        + np.where(
            np.asarray(bias_bits) > 0, adder_plut_cost_batch(w_hb), 0
        )
    )
