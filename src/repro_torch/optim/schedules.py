"""Learning-rate schedules as ``step -> lr`` callables.

The step count lives on the host (a Python int), so the rate is computed
there in float32, with the reference's operations in the reference's
order (``optim/schedules.py``); no device sync is needed to read it.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def warmup_cosine_schedule(
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    end_frac: float = 0.1,
):
    """Linear warmup then cosine decay to ``end_frac * peak_lr``."""
    def fn(step: int) -> np.float32:
        step = _F(step)
        warm = _F(peak_lr) * step / _F(max(1.0, warmup_steps))
        prog = (step - _F(warmup_steps)) / _F(
            max(1.0, total_steps - warmup_steps))
        prog = np.clip(prog, _F(0.0), _F(1.0))
        cos = _F(end_frac) + _F((1 - end_frac) * 0.5) * (
            _F(1) + np.cos(_F(np.pi) * prog))
        return warm if step < warmup_steps else _F(peak_lr) * cos
    return fn
