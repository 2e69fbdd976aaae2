"""Serving runtime of the port: prefill, decode, prefill replay, the KV
cache, the decode step captured in a CUDA graph, the continuous batcher,
the compressed-activation serving plans, and the serving control plane
(hot reload, degradation ladder; fault injection in :mod:`.faults`), and
sharded serving on a mesh of ranks (:mod:`.sharded`)."""
from .batching import ContinuousBatcher, Request
from .decode import decode_start, decode_step, prefill, prefill_replay
from .degrade import CompositeSupervisor, DegradationLadder
from .graphs import CapturedStep, decode_fn
from .kvcache import abstract_cache, clone_state, init_cache, state_leaves
from .plans import (
    ServingPlans,
    SitePlan,
    activation_sites,
    build_serving_plans,
    greedy_decode,
    verify_backend_equivalence,
)
from .reload import PlanReloader, ReloadRecord
from .sharded import (
    PlacementPolicy,
    ShardedServe,
    place_tables,
    plan_placement_report,
    serve_cache_shardings,
    serve_param_shardings,
)
from .stacked import MultiSiteSlabs, StackedPlanArrays, tables_nbytes

__all__ = ["prefill", "decode_step", "decode_start", "prefill_replay",
           "init_cache", "abstract_cache", "clone_state", "state_leaves",
           "CapturedStep", "decode_fn", "ContinuousBatcher", "Request",
           "ServingPlans", "SitePlan", "activation_sites",
           "build_serving_plans",
           "greedy_decode", "verify_backend_equivalence", "MultiSiteSlabs",
           "StackedPlanArrays", "tables_nbytes", "CompositeSupervisor",
           "DegradationLadder", "PlanReloader", "ReloadRecord",
           "ShardedServe", "PlacementPolicy", "place_tables",
           "plan_placement_report", "serve_param_shardings",
           "serve_cache_shardings"]
