"""Roofline terms of one rank's step (the port's counterpart of the
reference's ``roofline/analysis.py``).

Three terms per (arch x shape x mesh), all in seconds, per rank:

    compute    = FLOPs / (peak FLOP/s of one card)
    memory     = HBM bytes / (HBM bytes/s of one card)
    collective = collective bytes / (link bytes/s of one card)

The reference parses them out of the compiled XLA module's HLO.  The port
has no HLO: :mod:`.costs` counts them where the port's own step launches
its operations, on tensors without data in a dry run
(:mod:`repro_torch.launch.dryrun`) or on the card's tensors.  Each rank
runs its own program, so the counts are per rank, as the reference's
per-device SPMD module's are.

The constants keep the reference's names, with an NVIDIA H100 SXM5's
peaks (the ones ``chip_smoke.py`` bounds every kernel by).
"""
from __future__ import annotations

import dataclasses

# dense bf16 tensor-core peak of an H100 SXM5 (NVIDIA's H100 datasheet,
# 1979 TFLOP/s with sparsity, half that dense)
PEAK_FLOPS = 989e12
# dense TF32 and plain float32 (CUDA-core FMA) peaks of the same card
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
# HBM3 bandwidth of an H100 SXM5, bytes/s (datasheet)
HBM_BW = 3.35e12
# NVLink 4 of an H100 SXM5: 900 GB/s in both directions together, so
# 450e9 bytes/s each way.  This is NVLink, not the TPU's ICI; the name is
# the reference's, so that a reader finds it.
ICI_BW = 450e9


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    per_op_coll: dict

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "per_op_coll": self.per_op_coll,
        }


def analyze_costs(costs) -> RooflineTerms:
    """The terms of a :class:`.costs.StepCosts` (the counterpart of the
    reference's ``analyze_compiled``: no loop multipliers are needed, the
    port's layer and microbatch loops being Python loops whose every
    iteration was counted)."""
    return RooflineTerms(flops=costs.flops, hbm_bytes=costs.hbm_bytes,
                         coll_bytes=costs.coll_bytes,
                         per_op_coll=dict(costs.per_op_coll))


def model_flops_per_step(cfg, batch: int, seq: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D = batch
    tokens; train has the 3x backward factor, inference 2x N D."""
    n = cfg.n_active_params() if cfg.moe else cfg.n_params()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence
