"""Hand-written CUDA kernels of the port, with their plain versions.

K1 ``lut_act_stacked``, K2 ``lut_act``, K3 ``fused_matmul_lut``, K4
``lut_act_multi`` and K8 ``wkv`` replace the reference's five Pallas
kernels on the serving path; K5 ``lut_reconstruct``, K6 ``plain_lookup``
and K7 ``lutnn_layer`` the three of the LUT-NN toolflow.  K8b
``wkv_backward`` is K8's backward, for training.  Sources live in
``csrc/``; :mod:`.build` compiles them on first use (never at import).
"""
from .ops import (
    PlanArrays,
    add_launch_counts,
    fused_matmul_lut,
    launch_counts,
    lut_act,
    lut_act_multi,
    lut_act_stacked,
    lut_reconstruct,
    lutnn_layer,
    plain_lookup,
    reset_launch_counts,
    wkv,
    wkv_backward,
)

__all__ = ["PlanArrays", "add_launch_counts", "fused_matmul_lut",
           "launch_counts", "lut_act", "lut_act_multi", "lut_act_stacked",
           "lut_reconstruct", "lutnn_layer", "plain_lookup",
           "reset_launch_counts", "wkv", "wkv_backward"]
