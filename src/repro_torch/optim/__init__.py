"""AdamW and learning-rate schedules on tensors (own copy of the
reference's ``optim/``, in the reference's association)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedules import warmup_cosine_schedule

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "warmup_cosine_schedule",
]
