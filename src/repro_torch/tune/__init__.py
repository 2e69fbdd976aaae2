"""Tuned-plan artifacts of the port (the save and load halves of the
reference's ``tune`` package; the autotuner itself is ROADMAP queue A,
item 6).

    tp = tuned_plan_from_serving(cfg, plans)
    save_tuned_plan("tuned.npz", tp)
    # launch/serve --tuned-plan tuned.npz  (no recapture, no recompress)
"""
from .artifact import (
    TunedPlan,
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_serving,
)

__all__ = ["TunedPlan", "load_tuned_plan", "save_tuned_plan",
           "tuned_plan_from_serving"]
