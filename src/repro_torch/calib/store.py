"""Calibration artifact persistence: CalibrationSet <-> one ``.npz`` file
(own copy of the reference's ``calib/store.py``; the ``repro-calib/v2``
format, so either package loads the other's files).

Serve restarts should not pay recapture: a captured
:class:`~repro_torch.calib.masks.CalibrationSet` saves to a single
compressed ``.npz`` holding every mask (bit-exact bool vectors), the
histograms behind them (so masks can be re-derived with different knobs
without recapturing), and a JSON header with the quantizer parameters.
The round trip is bit-exact (``tests/test_torch_artifacts.py``), the
write is atomic, and the payload is content-checksummed on save and
verified on load (:mod:`repro_torch.ioutil`) — a truncated or bit-flipped
artifact raises a clear :class:`~repro_torch.ioutil.ArtifactError` naming
the file instead of deserializing garbage masks.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.ioutil import (
    ArtifactError,
    load_checked_npz,
    save_checked_npz,
)

from .masks import CalibrationSet

# v2 adds per-site observed output ranges ("range:" entries) for per-site
# w_out selection; v1 artifacts (no ranges) still load, with ranges=None.
_FORMAT = "repro-calib/v2"
_FORMATS = ("repro-calib/v1", "repro-calib/v2")
_MASK = "mask:"
_HIST = "hist:"
_RANGE = "range:"


def save_calibration(path: str, calib: CalibrationSet) -> str:
    """Write ``calib`` to ``path`` (``.npz`` appended if missing)."""
    header = {
        "format": _FORMAT,
        "w_in": calib.w_in,
        "x_lo": calib.x_lo,
        "x_hi": calib.x_hi,
        "meta": calib.meta,
    }
    payload: dict[str, np.ndarray] = {}
    for key, mask in calib.masks.items():
        payload[_MASK + key] = np.asarray(mask, dtype=bool)
    if calib.hists is not None:
        for key, hist in calib.hists.items():
            payload[_HIST + key] = np.asarray(hist, dtype=np.int64)
    if calib.ranges is not None:
        for key, rng in calib.ranges.items():
            payload[_RANGE + key] = np.asarray(rng, dtype=np.float64)
    return save_checked_npz(path, header, payload, kind="calibration")


def load_calibration(path: str) -> CalibrationSet:
    """Read a :func:`save_calibration` artifact back, bit-exactly."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    header, data = load_checked_npz(path, kind="calibration")
    if header.get("format") not in _FORMATS:
        raise ArtifactError(
            f"{path}: unknown calibration format "
            f"{header.get('format')!r} (expected one of {_FORMATS})")
    masks = {k[len(_MASK):]: np.asarray(v, dtype=bool)
             for k, v in data.items() if k.startswith(_MASK)}
    hists = {k[len(_HIST):]: np.asarray(v, dtype=np.int64)
             for k, v in data.items() if k.startswith(_HIST)}
    ranges = {k[len(_RANGE):]: np.asarray(v, dtype=np.float64)
              for k, v in data.items() if k.startswith(_RANGE)}
    return CalibrationSet(
        masks=masks,
        w_in=header["w_in"],
        x_lo=header["x_lo"],
        x_hi=header["x_hi"],
        hists=hists or None,
        ranges=ranges or None,
        meta=header.get("meta", {}),
    )
