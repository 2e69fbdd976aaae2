"""Logical lookup-table (L-LUT) specification.

A :class:`TableSpec` is the unit every algorithm in :mod:`repro_torch.core`
operates on: a fully tabulated function of ``w_in`` input bits producing
``w_out``-bit unsigned outputs, plus a *care* mask marking which entries were
actually observed (paper SS4.1 — unobserved entries are don't cares and may be
rewritten by the compressor).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TableSpec:
    values: np.ndarray  # (2**w_in,) int64, each in [0, 2**w_out)
    w_in: int
    w_out: int
    care: np.ndarray | None = None  # (2**w_in,) bool; None => all care
    name: str = "t"

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values, dtype=np.int64)
        n = 1 << self.w_in
        if self.values.shape != (n,):
            raise ValueError(
                f"{self.name}: values shape {self.values.shape} != ({n},)"
            )
        if self.values.min(initial=0) < 0 or self.values.max(initial=0) >= (1 << self.w_out):
            raise ValueError(f"{self.name}: values out of w_out={self.w_out} range")
        if self.care is not None:
            self.care = np.asarray(self.care, dtype=bool)
            if self.care.shape != (n,):
                raise ValueError(f"{self.name}: care shape mismatch")

    @property
    def size(self) -> int:
        return 1 << self.w_in

    def care_mask(self) -> np.ndarray:
        if self.care is None:
            return np.ones(self.size, dtype=bool)
        return self.care

    @property
    def n_dontcare(self) -> int:
        return int((~self.care_mask()).sum())

    @staticmethod
    def random(
        w_in: int,
        w_out: int,
        dontcare_frac: float = 0.0,
        seed: int = 0,
        smooth: bool = False,
        name: str = "t",
    ) -> "TableSpec":
        """Random table generator used by tests and synthetic benchmarks.

        ``smooth=True`` produces a monotone-ish table (classic elementary-
        function shape, compressible); ``smooth=False`` produces the
        random-looking tables typical of LUT-based NNs (paper SS1).
        """
        rng = np.random.default_rng(seed)
        n = 1 << w_in
        hi = 1 << w_out
        if smooth:
            xs = np.linspace(0.0, 1.0, n)
            f = 0.5 * (1 + np.sin(2.2 * np.pi * xs)) * (hi - 1)
            noise = rng.integers(0, max(1, hi // 64), size=n)
            values = np.clip(f.astype(np.int64) + noise, 0, hi - 1)
        else:
            values = rng.integers(0, hi, size=n, dtype=np.int64)
        care = None
        if dontcare_frac > 0:
            care = rng.random(n) >= dontcare_frac
        return TableSpec(values=values, w_in=w_in, w_out=w_out, care=care, name=name)
