"""The paper's sweeps on the device: Table 2 (with the serial-vs-engine
timing), Fig. 3's exiguity sweep and the beyond-paper variants.

Counterpart of the reference's ``benchmarks/`` sections of the same
names; ``python -m repro_torch.bench.run`` runs all three.
"""
from . import beyond, fig3, table2
from .common import TrainedNet, compress_and_eval, get_trained

__all__ = ["TrainedNet", "beyond", "compress_and_eval", "fig3",
           "get_trained", "table2"]
