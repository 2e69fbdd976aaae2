"""Bit-level helpers shared across the ReducedLUT core."""
from __future__ import annotations

import numpy as np


def bits_for_value(v: int) -> int:
    """Number of bits needed to represent unsigned value ``v`` (0 -> 0)."""
    if v < 0:
        raise ValueError(f"unsigned value expected, got {v}")
    return int(v).bit_length()


def bits_for_count(n: int) -> int:
    """Address bits needed to index ``n`` distinct entries (1 -> 0)."""
    if n <= 0:
        raise ValueError(f"positive count expected, got {n}")
    return int(n - 1).bit_length()


def pack_bits(cols: list[np.ndarray], widths: list[int]) -> np.ndarray:
    """Pack integer columns (LSB first) into a single integer array."""
    out = np.zeros_like(cols[0], dtype=np.int64)
    shift = 0
    for col, w in zip(cols, widths):
        out |= (col.astype(np.int64) & ((1 << w) - 1)) << shift
        shift += w
    return out


def unpack_bits(packed: np.ndarray, widths: list[int]) -> list[np.ndarray]:
    """Inverse of :func:`pack_bits` (LSB first)."""
    out = []
    shift = 0
    for w in widths:
        out.append((packed >> shift) & ((1 << w) - 1))
        shift += w
    return out
