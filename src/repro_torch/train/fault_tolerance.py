"""Fault tolerance (the reference's ``train/fault_tolerance.py``, plain
Python, the same behaviour): supervised step loop with checkpoint/restart,
heartbeats, straggler detection, and failure injection for tests.

At 1000+ node scale the failure model is: any step may raise (device loss,
preemption), any host may stall (straggler).  The supervisor provides:
  * periodic step-atomic checkpoints (train/checkpoint.py)
  * automatic restart from the latest checkpoint with deterministic data
    skip-ahead (TokenStream batches are pure functions of the step); the
    port's step and restore work on the state in place, so a restart
    overwrites whatever a failed step left, and a run that starts without
    a checkpoint first writes its starting state (as ``step_<start - 1>``,
    the state after the step before the first): the reference's cold
    restart retries on the untouched pre-step state, which an in-place
    step does not keep
  * heartbeat tracking with a straggler monitor (robust z-score on step
    latency); on real clusters the monitor feeds the re-sharding /
    hot-spare swap decision — here it exposes the signal and is unit
    tested with a fake clock
  * bounded retry with exponential backoff
  * on a mesh of ranks (``shardings``, :func:`repro_torch.train.state.
    train_state_shardings`), checkpoints of the ranks' shares and a
    failure agreed by every rank: after each step the ranks all-reduce
    whether it raised anywhere, and if it did every rank restores from the
    latest checkpoint, so a restarted run is bit for bit an uninterrupted
    one.  The agreement sits at a step's end: a rank that raises inside a
    collective leaves its peers waiting in it, and one that raises after
    the agreement (in its metrics or its checkpoint) has peers that went
    on, so either fails the run (the launcher stops every rank)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from .checkpoint import (
    _mesh_of,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps whose latency is an outlier vs the trailing window."""

    window: int = 50
    threshold: float = 4.0   # robust z-score (MAD-based)
    _lat: list = dataclasses.field(default_factory=list)

    def observe(self, seconds: float) -> bool:
        """Record a step latency; returns True if it is a straggler."""
        lat = self._lat
        is_straggler = False
        if len(lat) >= 8:
            med = sorted(lat)[len(lat) // 2]
            mad = sorted(abs(x - med) for x in lat)[len(lat) // 2] + 1e-9
            z = 0.6745 * (seconds - med) / mad
            is_straggler = z > self.threshold
        lat.append(seconds)
        if len(lat) > self.window:
            lat.pop(0)
        return is_straggler


class _PeerFailed(RuntimeError):
    """Another rank's step raised (the ranks' agreement said so)."""


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    backoff_s: float = 0.0           # 0 for tests; >0 in production
    clock: Callable[[], float] = time.monotonic
    shardings: dict | None = None    # a rank's state on a mesh

    def run(
        self,
        state,
        step_fn,                      # (state, batch) -> (state, metrics)
        batch_fn,                     # step -> batch
        n_steps: int,
        start_step: int = 0,
        on_metrics=None,
    ):
        """Run the loop with restart-on-failure. Returns (state, stats).
        Without a checkpoint yet, ``state`` is saved as ``step_<start_step
        - 1>`` first, so every restart restores."""
        from repro_torch.nn.sharding import all_ranks_ok

        mesh = _mesh_of(self.shardings)
        save = lambda s, k: save_checkpoint(self.ckpt_dir, s, k,
                                            shardings=self.shardings)
        restore = lambda s: restore_checkpoint(self.ckpt_dir, s,
                                               shardings=self.shardings)
        monitor = StragglerMonitor()
        restarts = 0
        stats = {"stragglers": 0, "restarts": 0, "heartbeat": []}
        step = start_step
        if latest_step(self.ckpt_dir) is not None:
            state, step = restore(state)
            step += 1
        else:
            save(state, start_step - 1)
        while step < n_steps:
            agreed = False
            try:
                t0 = self.clock()
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                if mesh is not None:
                    agreed = True
                    if not all_ranks_ok(mesh, True):
                        raise _PeerFailed(f"Supervisor: step {step} failed "
                                          f"on another rank")
                dt = self.clock() - t0
                if monitor.observe(dt):
                    stats["stragglers"] += 1
                stats["heartbeat"].append((step, dt))
                if on_metrics:
                    on_metrics(step, metrics)
                if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                    save(state, step)
                step += 1
            except Exception as e:
                if mesh is not None and not agreed:
                    all_ranks_ok(mesh, False)
                elif agreed and not isinstance(e, _PeerFailed):
                    raise   # past the agreement: the peers went on
                restarts += 1
                stats["restarts"] = restarts
                if restarts > self.max_restarts:
                    raise
                if self.backoff_s:
                    time.sleep(self.backoff_s * 2 ** (restarts - 1))
                state, step = restore(state)
                step += 1
        return state, stats
