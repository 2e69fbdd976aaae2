"""Serving runtime of the port: prefill, decode, KV cache, and the
compressed-activation serving plans."""
from .decode import decode_step, prefill
from .kvcache import init_cache
from .plans import (
    ServingPlans,
    SitePlan,
    build_serving_plans,
    greedy_decode,
    verify_backend_equivalence,
)
from .stacked import MultiSiteSlabs, StackedPlanArrays, tables_nbytes

__all__ = ["prefill", "decode_step", "init_cache", "ServingPlans",
           "SitePlan", "build_serving_plans",
           "greedy_decode", "verify_backend_equivalence", "MultiSiteSlabs",
           "StackedPlanArrays", "tables_nbytes"]
