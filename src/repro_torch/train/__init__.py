"""Training on one device (the reference's ``train/`` package): the train
state, the train step, int8 error-feedback compression, step-atomic
checkpoints in the reference's layout, and the supervised loop.  Serving's
counterparts of the reference's ``make_serve_step`` / ``make_prefill``
live in :mod:`repro_torch.serve`; ``train_state_shardings`` and
``abstract_train_state`` wait for ROADMAP queue A items 11 and 12."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .fault_tolerance import StragglerMonitor, Supervisor
from .state import TrainConfig, init_train_state
from .step import input_batch_specs, make_train_step

__all__ = [
    "TrainConfig", "init_train_state", "make_train_step",
    "input_batch_specs", "save_checkpoint", "restore_checkpoint",
    "latest_step", "Supervisor", "StragglerMonitor",
]
