"""Roofline analysis of the port's step (the reference's ``roofline/``):
the terms against an H100's peaks (:mod:`.analysis`), the costs counted
where the step launches its work (:mod:`.costs`), and the dry run's tables
(:mod:`.report`)."""
from .analysis import (
    HBM_BW,
    ICI_BW,
    PEAK_F32_FLOPS,
    PEAK_FLOPS,
    PEAK_TF32_FLOPS,
    RooflineTerms,
    analyze_costs,
    model_flops_per_step,
)
from .costs import StepCosts, count_costs

__all__ = [
    "RooflineTerms", "analyze_costs", "model_flops_per_step", "PEAK_FLOPS",
    "PEAK_TF32_FLOPS", "PEAK_F32_FLOPS", "HBM_BW", "ICI_BW", "StepCosts",
    "count_costs",
]
