"""ReducedLUT core: table decomposition with don't-care conditions.

Public API:
  - :class:`TableSpec` — logical LUT + care mask
  - :func:`compress_table` / :func:`compress_network` — the paper's flow
  - :class:`CompressConfig` — exiguity / search-space knobs
  - plans (:class:`PlainPlan` / :class:`DecomposedPlan`) with bit-exact
    reconstruction, analytical P-LUT cost and Verilog emission

A copy of the reference package's numpy engine and Verilog emitter, so
the PyTorch port builds byte-identical plans (and Verilog text) without
importing the reference.
"""
from .cost_model import (
    adder_plut_cost,
    rom_plut_cost,
    shifter_plut_cost,
)
from .engine import (
    CompressReport,
    PlanCache,
    TableReport,
    compress_network_report,
)
from .pipeline import (
    CompressConfig,
    compress_network,
    compress_network_serial,
    compress_table,
    compress_table_serial,
    rom_baseline_cost,
    verify_care_exact,
)
from .plan import DecomposedPlan, Plan, PlainPlan, load_plans, save_plans
from .reduced import reduce_uniques
from .similarity import Decomposition, make_decomposition
from .table import TableSpec
from .verilog import network_to_verilog, plan_to_verilog

__all__ = [
    "TableSpec",
    "CompressConfig",
    "CompressReport",
    "PlanCache",
    "TableReport",
    "compress_table",
    "compress_table_serial",
    "compress_network",
    "compress_network_serial",
    "compress_network_report",
    "rom_baseline_cost",
    "verify_care_exact",
    "Plan",
    "PlainPlan",
    "DecomposedPlan",
    "save_plans",
    "load_plans",
    "Decomposition",
    "make_decomposition",
    "plan_to_verilog",
    "network_to_verilog",
    "reduce_uniques",
    "rom_plut_cost",
    "adder_plut_cost",
    "shifter_plut_cost",
]
