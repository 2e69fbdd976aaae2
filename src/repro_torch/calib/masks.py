"""Observed-pattern histograms -> per-site care masks (paper SS4.1); own
copy of the reference's ``calib/masks.py`` (numpy).

The rule is the paper's: an input pattern never observed during
calibration is a don't care the compressor may rewrite.  Two knobs guard
against over-aggressive don't-caring from finite calibration sets:

* ``min_count`` / ``smoothing`` — laplace-style neighbor smoothing: the
  histogram is convolved with a ``2*smoothing + 1``-wide box (every
  observation also credits its ``smoothing`` nearest bins) before the
  ``count >= min_count`` threshold.  A near-miss bin adjacent to heavy
  mass stays care; an isolated far-tail bin needs its own observations.
* ``coverage`` — keep only the highest-count bins whose cumulative mass
  reaches this fraction of all observations (e.g. ``0.999`` drops
  one-in-a-thousand outlier bins), intersected with the count threshold.

:class:`CalibrationSet` is the unit the rest of the system consumes:
:func:`repro_torch.serve.plans.build_serving_plans` turns it into per-site
:class:`~repro_torch.core.TableSpec` care masks, and
:mod:`.store` saves and loads it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .capture import ActivationCapture, site_key


@dataclasses.dataclass
class CalibrationSet:
    """Per-site observed-pattern masks (plus the histograms behind them).

    ``masks`` maps site keys (``"L{layer}/{site}"``, or a bare site kind
    for layer-agnostic captures, or ``"L{l}/n{i}"`` for LUT-NN neurons) to
    boolean care vectors.  ``w_in``/``x_lo``/``x_hi`` describe the input
    quantizer the masks were captured under; activation-serving consumers
    require them, LUT-NN masks (heterogeneous widths) may leave ``w_in``
    as ``None``.
    """

    masks: dict[str, np.ndarray]
    w_in: int | None = None
    x_lo: float = -8.0
    x_hi: float = 8.0
    hists: dict[str, np.ndarray] | None = None
    ranges: dict[str, np.ndarray] | None = None   # key -> [y_lo, y_hi]
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.masks = {k: np.asarray(m, dtype=bool)
                      for k, m in self.masks.items()}
        if self.hists is not None:
            self.hists = {k: np.asarray(h, dtype=np.int64)
                          for k, h in self.hists.items()}
        if self.ranges is not None:
            self.ranges = {k: np.asarray(r, dtype=np.float64)
                           for k, r in self.ranges.items()}

    def mask_for(self, site: str, layer: int | None = None
                 ) -> np.ndarray | None:
        """Resolve a site's care mask, falling back from the per-layer key
        to the layer-agnostic site kind (shared-capture families)."""
        for key in (site_key(site, layer), site):
            if key in self.masks:
                return self.masks[key]
        return None

    def range_for(self, site: str, layer: int | None = None
                  ) -> np.ndarray | None:
        """Resolve a site's observed output range ``[y_lo, y_hi]`` (same
        per-layer -> site-kind fallback as :meth:`mask_for`); ``None`` when
        the calibration predates output-range capture (a v1 artifact)."""
        if self.ranges is None:
            return None
        for key in (site_key(site, layer), site):
            if key in self.ranges:
                return self.ranges[key]
        return None

    def sites(self) -> list[str]:
        return sorted(self.masks)

    @property
    def per_layer(self) -> bool:
        return any("/" in k for k in self.masks)

    def dontcare_frac(self, key: str) -> float:
        m = self.masks[key]
        return float(1.0 - m.mean())

    def summary(self) -> str:
        parts = [f"{k}: {int(m.sum())}/{m.size} care" for k, m in
                 sorted(self.masks.items())]
        return (f"calibration[w_in={self.w_in}, "
                f"x=[{self.x_lo}, {self.x_hi}]] " + ", ".join(parts))


def care_mask_from_hist(hist: np.ndarray, *, min_count: int = 1,
                        smoothing: int = 0,
                        coverage: float | None = None) -> np.ndarray:
    """One histogram -> boolean care mask (see module docstring knobs)."""
    h = np.asarray(hist, dtype=np.float64)
    if min_count < 1:
        raise ValueError(f"min_count must be >= 1, got {min_count}")
    smoothed = h
    if smoothing > 0:
        smoothed = np.convolve(h, np.ones(2 * smoothing + 1), mode="same")
    mask = smoothed >= min_count
    if coverage is not None:
        if not 0.0 < coverage <= 1.0:
            raise ValueError(f"coverage must be in (0, 1], got {coverage}")
        total = h.sum()
        if total > 0:
            order = np.argsort(-h, kind="stable")
            cum = np.cumsum(h[order])
            keep_n = int(np.searchsorted(cum, coverage * total) + 1)
            kept = np.zeros(h.size, dtype=bool)
            kept[order[:keep_n]] = True
            mask &= kept
    if not mask.any():
        raise ValueError(
            f"care_mask_from_hist: the mask keeps zero care bins "
            f"(min_count={min_count}, smoothing={smoothing}, "
            f"coverage={coverage}; histogram has "
            f"{int((h > 0).sum())} observed bins over "
            f"{int(h.sum())} samples) — an all-don't-care table is "
            f"unconstrained and the compressor may rewrite every entry; "
            f"relax the knobs or capture more batches")
    return mask


def fold_hist(hist: np.ndarray, w_to: int) -> np.ndarray:
    """Re-bin a ``2**w_from``-bin histogram onto the coarser ``2**w_to``
    input grid (both uniform over the same ``[x_lo, x_hi]``).

    Each fine bin's count is credited to the coarse code its bin center
    quantizes to (the runtime quantizer's round-to-nearest rule), so one
    capture at the widest sweep ``w_in`` serves every narrower candidate
    without recapturing.  Values inside a fine bin that straddles a
    coarse boundary go to the center's side: the approximation is one
    fine bin wide.
    """
    h = np.asarray(hist, dtype=np.int64)
    n_from = h.size
    if n_from & (n_from - 1):
        raise ValueError(f"fold_hist: histogram size {n_from} is not a "
                         f"power of two")
    w_from = int(np.log2(n_from))
    if w_to == w_from:
        return h.copy()
    if w_to > w_from:
        raise ValueError(
            f"fold_hist: cannot refine a w_in={w_from} histogram to "
            f"w_in={w_to} — capture at the widest grid in the sweep")
    fine = np.arange(n_from, dtype=np.float64) / (n_from - 1)
    codes = np.rint(fine * ((1 << w_to) - 1)).astype(np.int64)
    out = np.zeros(1 << w_to, dtype=np.int64)
    np.add.at(out, codes, h)
    return out


def calibration_from_capture(cap: ActivationCapture, *, min_count: int = 1,
                             smoothing: int = 0,
                             coverage: float | None = None,
                             ) -> CalibrationSet:
    """Derive per-site care masks from a finished capture.

    Mirrors :func:`repro_torch.nn.lut_act.calibrate_bins`' degenerate-input
    guards: a site whose mask would keep fewer than two bins (empty or
    constant calibration) raises instead of producing an unconstrained
    table the compressor may rewrite into garbage.
    """
    if not cap.hists:
        raise ValueError(
            "calibration_from_capture: capture saw no activation sites — "
            "run capture_model (or enter the capture context around a "
            "forward pass) first")
    masks: dict[str, np.ndarray] = {}
    for key, hist in cap.hists.items():
        mask = care_mask_from_hist(hist, min_count=min_count,
                                   smoothing=smoothing, coverage=coverage)
        if int(mask.sum()) < 2:
            raise ValueError(
                f"calibration_from_capture: site {key!r} has "
                f"{int(mask.sum())} care bins after thresholding "
                f"(observed {int((hist > 0).sum())} bins, "
                f"{int(hist.sum())} samples) — the table would be "
                f"all-don't-care away from at most one entry; capture more "
                f"batches or relax min_count/coverage")
        masks[key] = mask
    ranges = cap.observed_ranges() if hasattr(cap, "observed_ranges") else None
    return CalibrationSet(
        masks=masks, w_in=cap.w_in, x_lo=cap.x_lo, x_hi=cap.x_hi,
        hists={k: h.copy() for k, h in cap.hists.items()},
        ranges=ranges or None,
        meta={"n_batches": cap.n_batches, "n_samples": cap.n_samples,
              "min_count": min_count, "smoothing": smoothing,
              "coverage": coverage},
    )
