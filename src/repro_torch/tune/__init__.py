"""Accuracy-parity autotuner of the port (the reference's ``tune``
package): trained model -> calibrated compression -> measured served
quality -> Pareto-optimal per-site plans.

    params, info = trained_params(cfg, ckpt_dir=...)     # parity.py
    cap = capture_model(params, cfg, calib_batches)      # repro_torch.calib
    outcome = autotune(cfg, params, cap,                 # sweep.py
                       batches=heldout_batches(cfg, 4),
                       budget=0.01)
    tp = tuned_plan_from_outcome(cfg, outcome)           # artifact.py
    save_tuned_plan("tuned.npz", tp)
    # launch/serve --tuned-plan tuned.npz  (no recapture, no recompress)

``launch/tune.py`` is the command line over this flow.
"""
from .artifact import (
    TunedPlan,
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_outcome,
    tuned_plan_from_serving,
)
from .parity import (
    ParityHarness,
    ParityMetrics,
    greedy_tokens,
    heldout_batches,
    model_logits,
    served_parity,
    trained_params,
)
from .pareto import greedy_select, pareto_frontier, select_by_budget
from .sweep import (
    SweepPoint,
    SweepResult,
    TuneOutcome,
    autotune,
    build_point_plans,
    calibration_for,
    default_grid,
    resolve_w_out,
    run_sweep,
    w_out_from_ranges,
)

__all__ = [
    "ParityHarness",
    "ParityMetrics",
    "SweepPoint",
    "SweepResult",
    "TuneOutcome",
    "TunedPlan",
    "autotune",
    "build_point_plans",
    "calibration_for",
    "default_grid",
    "greedy_select",
    "greedy_tokens",
    "heldout_batches",
    "load_tuned_plan",
    "model_logits",
    "pareto_frontier",
    "resolve_w_out",
    "run_sweep",
    "save_tuned_plan",
    "select_by_budget",
    "served_parity",
    "trained_params",
    "tuned_plan_from_outcome",
    "tuned_plan_from_serving",
    "w_out_from_ranges",
]
