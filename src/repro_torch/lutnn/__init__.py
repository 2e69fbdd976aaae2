"""LUT-based neural networks (LogicNets/NeuraLUT family, paper SS2.1/SS5.1).

Counterpart of the reference's ``lutnn/``: differentiable training (STE
quantization) on the device, truth-table extraction, don't-care
identification from training data, and bit-exact table-network inference
through kernel K7 — the paper's toolflow (Fig. 2).
"""
from .extract import (
    extract_tables,
    mark_observed,
    mark_observed_calibration,
    network_table_specs,
    observed_calibration_set,
    specs_to_tables,
)
from .inference import (
    pack_codes,
    quantize_codes,
    quantize_input,
    reconstruct_tables,
    table_accuracy,
    table_forward,
)
from .model import (
    LUTNN,
    LUTNNConfig,
    device_tables,
    lutnn_forward,
    lutnn_init,
    paper_model,
)
from .train import train_lutnn

__all__ = [
    "LUTNN",
    "LUTNNConfig",
    "device_tables",
    "extract_tables",
    "lutnn_forward",
    "lutnn_init",
    "mark_observed",
    "mark_observed_calibration",
    "network_table_specs",
    "observed_calibration_set",
    "pack_codes",
    "paper_model",
    "quantize_codes",
    "quantize_input",
    "reconstruct_tables",
    "specs_to_tables",
    "table_accuracy",
    "table_forward",
    "train_lutnn",
]
