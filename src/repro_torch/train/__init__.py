"""Training (the reference's ``train/`` package), on one device or on a
mesh of ranks: the train state and its placements, the train step, int8
error-feedback compression, step-atomic checkpoints in the reference's
layout (with elastic re-mesh), and the supervised loop.  Serving's
counterparts of the reference's ``make_serve_step`` / ``make_prefill``
live in :mod:`repro_torch.serve`; ``abstract_train_state`` builds the
state without data for the dry run (:mod:`repro_torch.launch.dryrun`)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import StragglerMonitor, Supervisor
from .state import (
    TrainConfig,
    abstract_train_state,
    init_train_state,
    shard_train_state,
    train_param_shardings,
    train_state_shardings,
)
from .step import (
    abstract_batch,
    batch_shardings,
    input_batch_specs,
    make_train_step,
)

__all__ = [
    "TrainConfig", "abstract_train_state", "init_train_state",
    "make_train_step", "input_batch_specs", "abstract_batch",
    "batch_shardings", "save_checkpoint", "restore_checkpoint",
    "latest_step", "Supervisor", "StragglerMonitor",
    "train_param_shardings", "train_state_shardings", "shard_train_state",
]
