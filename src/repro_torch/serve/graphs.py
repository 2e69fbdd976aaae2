"""The decode step captured in a CUDA graph: the port's counterpart of the
reference's ``jax.jit(decode_step)`` (``launch/serve.py`` and the batcher's
step and replay).

An eager decode step issues some three thousand kernels from Python, and
the card waits on the host between them.  :class:`CapturedStep` records
one step of :func:`~repro_torch.serve.decode.decode_step` once and
replays it per token:

* **Capture.** Static ``tokens (B, 1)`` and ``pos`` buffers, the cache
  dict it was captured against (flat, or nested as the hybrid family's;
  the graph reads and writes those tensors in place, so every state
  update of the step, the hybrid's conv shift, LRU state and ring write
  included, is an in-place write, never a rebound name; an encdec
  cache's cross K/V ``xk`` / ``xv`` are read and never written), PyTorch's
  recipe: warm-up steps on a side stream, on a copy
  of the cache so that they change nothing the caller holds, then one
  step captured with ``torch.cuda.graph`` on the same side stream (cuBLAS
  keeps a handle and workspace per stream).
* **Replay.** Each call copies the token column and the position into the
  static buffers, replays, and returns the graph's logits buffer: the
  caller reads it before the next call.
* **Recapture.** A call with other cache tensors, another batch size, or
  after ``lut_tables`` or ``cfg`` changed captures again.
* **Launch counts.** Each wrapper's count stays what eager would show:
  the launches the capture recorded are added on every replay, and the
  capture itself (warm-up included) counts none.  The telemetry's
  ``kernel_launches_total`` follows the same rule
  (:func:`repro_torch.kernels.ops.recording`).
* **Drift monitor.** A step captured while a don't-care monitor is
  active (:mod:`repro_torch.obs.drift`) records the monitor's counting
  ops, which add into its device counters at every replay; the capture
  key holds the active monitor (``None`` under ``suppressed()``), so
  another monitor captures again.  The warm-up steps run for real, so
  the monitor's counters are saved before them and put back after: only
  served steps count.
* **Memory pool.** Steps given one ``pool`` (a
  ``torch.cuda.graph_pool_handle()``) capture into one memory pool: the
  batcher's monitored and plain steps, which never run at once, share
  their scratch memory.

Nothing falls back: a capture that fails, or a kernel that fails inside
it, raises, and leaves no graph behind (the next call captures afresh;
the serving control plane's ladder answers such a fault with
``swap_tables``, which captures again).  CUDA graphs exist only on the
card; on the CPU, which a caller has to ask for, :func:`decode_fn`
returns the eager step.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import add_launch_counts, launch_counts, ops
from repro_torch.obs import drift as obs_drift

from .decode import decode_step
from .kvcache import clone_state, state_leaves

WARMUP_STEPS = 2


class CapturedStep:
    """``decode_step(params, cfg, cache, tokens, pos, lut_tables)`` as a
    replayed CUDA graph; called as ``step(cache, tokens, pos) -> (logits,
    cache)``, like the eager step."""

    def __init__(self, params, cfg: ArchConfig, lut_tables=None, pool=None):
        self.params = params
        self.cfg = cfg
        self.lut_tables = lut_tables
        self.pool = pool           # a graph pool handle shared, or None
        self.graph = None
        self.captures = 0          # captures made so far
        self.capture_s = 0.0       # host seconds of the last capture
        self.per_replay = {}       # wrapper -> launches a replay makes
        self.per_replay_points = {}   # telemetry point -> launches
        self._key = None

    def _key_of(self, cache: dict, tokens: torch.Tensor) -> tuple:
        return (tuple((n, t.data_ptr(), tuple(t.shape), t.dtype)
                      for n, t in state_leaves(cache)),
                tuple(tokens.shape), id(self.lut_tables), self.cfg,
                obs_drift.current())

    def reset(self) -> None:
        """Drop the graph and its memory pool."""
        self.graph = self._logits = self._tokens = self._pos = None
        self._key = None

    def capture(self, cache: dict, tokens: torch.Tensor) -> None:
        """Capture one step against ``cache`` (its tensors in place) for a
        batch of ``tokens``' shape; :meth:`__call__` does this on its own
        when needed."""
        dev = tokens.device
        if dev.type != "cuda":
            raise ValueError(f"CapturedStep: tokens on {dev}; CUDA graphs "
                             f"run on the card (the CPU steps eagerly)")
        self.reset()
        t0 = time.perf_counter()
        before = launch_counts()
        mon = obs_drift.current()
        counts = mon.snapshot_counts() if mon is not None else None
        tok = torch.zeros(tokens.shape, dtype=torch.long, device=dev)
        pos = torch.zeros((), dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), ops.recording():
                scratch = clone_state(cache)
                for _ in range(WARMUP_STEPS):
                    decode_step(self.params, self.cfg, scratch, tok, pos,
                                self.lut_tables)
                del scratch
            mid = launch_counts()
            with torch.cuda.graph(graph, stream=side, pool=self.pool), \
                    ops.recording() as points:
                logits, _ = decode_step(self.params, self.cfg, cache, tok,
                                        pos, self.lut_tables)
            after = launch_counts()
        finally:
            torch.cuda.current_stream(dev).wait_stream(side)
            now = launch_counts()
            add_launch_counts({k: before[k] - now[k] for k in now})
            if mon is not None:
                mon.restore_counts(counts)
        self.per_replay = {k: after[k] - mid[k] for k in after
                           if after[k] != mid[k]}
        self.per_replay_points = points
        self.graph, self._logits, self._tokens, self._pos = (
            graph, logits, tok, pos)
        self._key = self._key_of(cache, tokens)
        self.captures += 1
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, cache: dict, tokens: torch.Tensor, pos):
        if self.graph is None or self._key_of(cache, tokens) != self._key:
            self.capture(cache, tokens)
        self._tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos)
        else:
            self._pos.fill_(pos)
        self.graph.replay()
        add_launch_counts(self.per_replay)
        ops.note_launches(self.per_replay_points)
        return self._logits, cache


def decode_fn(params, cfg: ArchConfig, lut_tables=None, pool=None):
    """The decode step a serving loop calls, ``(cache, tokens, pos) ->
    (logits, cache)``: a :class:`CapturedStep` (into ``pool`` when given)
    where the parameters lie on the card, the eager :func:`decode_step`
    where they lie on the CPU."""
    if params.embed.device.type == "cuda":
        return CapturedStep(params, cfg, lut_tables, pool=pool)
    return lambda cache, tokens, pos: decode_step(params, cfg, cache, tokens,
                                                  pos, lut_tables)
