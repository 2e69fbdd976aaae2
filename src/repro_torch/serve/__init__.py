"""Serving runtime of the port: prefill, decode, prefill replay, the KV
cache, the decode step captured in a CUDA graph, the continuous batcher,
and the compressed-activation serving plans."""
from .batching import ContinuousBatcher, Request
from .decode import decode_start, decode_step, prefill, prefill_replay
from .graphs import CapturedStep, decode_fn
from .kvcache import clone_state, init_cache, state_leaves
from .plans import (
    ServingPlans,
    SitePlan,
    build_serving_plans,
    greedy_decode,
    verify_backend_equivalence,
)
from .stacked import MultiSiteSlabs, StackedPlanArrays, tables_nbytes

__all__ = ["prefill", "decode_step", "decode_start", "prefill_replay",
           "init_cache", "clone_state", "state_leaves",
           "CapturedStep", "decode_fn", "ContinuousBatcher", "Request",
           "ServingPlans", "SitePlan", "build_serving_plans",
           "greedy_decode", "verify_backend_equivalence", "MultiSiteSlabs",
           "StackedPlanArrays", "tables_nbytes"]
