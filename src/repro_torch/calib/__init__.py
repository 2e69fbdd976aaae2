"""Per-site streaming calibration: the serving stack's don't-care front end.

    capture_model(params, cfg, batches)      # stream activations per site
      -> calibration_from_capture(cap)       # observed bins -> care masks
      -> serve.plans.build_serving_plans(cfg, calibration_set)
"""
from .capture import (
    ActivationCapture,
    capture_active,
    capture_model,
    current,
    model_batch,
    site_key,
    synthetic_batches,
)
from .masks import (
    CalibrationSet,
    calibration_from_capture,
    care_mask_from_hist,
    fold_hist,
)
from .store import load_calibration, save_calibration


def capture_calibration(params, cfg, batches, *, w_in=None, x_lo=-8.0,
                        x_hi=8.0, min_count=1, smoothing=0, coverage=None
                        ) -> CalibrationSet:
    """One-stop capture -> masks over the exact forward."""
    cap = capture_model(params, cfg, batches, w_in=w_in, x_lo=x_lo,
                        x_hi=x_hi)
    return calibration_from_capture(cap, min_count=min_count,
                                    smoothing=smoothing, coverage=coverage)


__all__ = [
    "ActivationCapture",
    "CalibrationSet",
    "calibration_from_capture",
    "capture_active",
    "capture_calibration",
    "capture_model",
    "care_mask_from_hist",
    "current",
    "fold_hist",
    "load_calibration",
    "model_batch",
    "save_calibration",
    "site_key",
    "synthetic_batches",
]
