"""Hand-written CUDA kernels of the LUT hot path, with their plain versions.

K1 ``lut_act_stacked``, K2 ``lut_act`` and K3 ``fused_matmul_lut`` replace
the reference's three Pallas kernels on the serving path.  Sources live in
``csrc/``; :mod:`.build` compiles them on first use (never at import).
"""
from .ops import (
    PlanArrays,
    fused_matmul_lut,
    launch_counts,
    lut_act,
    lut_act_stacked,
    reset_launch_counts,
)

__all__ = ["PlanArrays", "fused_matmul_lut", "launch_counts", "lut_act",
           "lut_act_stacked", "reset_launch_counts"]
