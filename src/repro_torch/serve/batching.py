"""Continuous batching: a slot-based request scheduler over decode steps
(PyTorch port of the reference's ``serve/batching.py``).

A fixed pool of B slots shares one decode step; finished or empty slots
are refilled with queued requests, whose prompts go through the shared
cache at the slot's own positions, so the step never changes shape and a
step captured in a CUDA graph (:mod:`.graphs`) serves every tick.

The scheduling logic is the reference's, line for line: per-slot
positions, admission and refill, eviction on EOS, on ``max_new`` and at
``max_seq`` (with the position assertion), one step call per distinct
slot position, with the other rows' ``k`` / ``v`` / ``k_scale`` /
``v_scale`` entries snapshotted and restored around it, prefill replay
(``prefill="replay"``) with truncation of over-long prompts,
``swap_tables``, the supervisor's ``on_tick`` / ``on_fault`` hooks with
six supervised retries, stall detection, ``utilization`` and
``metrics()``.

The step and the replay run through :func:`.graphs.decode_fn`: captured
on the card, eager on the CPU.  The reference's telemetry (its ``obs``
counters, events and registry histograms) and the drift monitor's second
step program are not ported yet (ROADMAP queue A, item 8), and sharded
serving (``mesh``) is queue A item 11.

Caveat, as in the reference: the snapshot and restore cover only the
attention cache.  An ssm (RWKV6) step advances every row's recurrent
state, so a tick with slots at two positions would advance a row twice,
and idle slots advance too; the batcher serves the decoder families
(dense and moe).  A moe step routes all B rows together, so a row's
experts could see another row's tokens only through a dropped
assignment; at decode no expert sees more tokens than rows, and with
capacity >= B (8 at 4 slots on both moe configurations, at least 2B on
their smoke configs) nothing is dropped and rows stay independent, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

from .decode import prefill_replay
from .graphs import decode_fn
from .kvcache import init_cache

# the cache entries a step writes at its position for every row
_KV = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    slo_ms: float | None = None    # per-request latency objective
    t_submit: float | None = None  # stamped by submit()
    t_first: float | None = None   # first output token
    t_done: float | None = None    # eviction

    @property
    def latency_s(self) -> float | None:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> float | None:
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0            # next cache position for this slot
    pending: list = None    # prompt tokens not yet ingested


class ContinuousBatcher:
    """Schedules requests over a fixed (B, max_seq) decode pool on the
    parameters' device."""

    def __init__(self, cfg: ArchConfig, params, batch_size: int,
                 max_seq: int, eos_token: int = 0,
                 kv_dtype: str = "bfloat16", lut_tables: dict | None = None,
                 prefill: str = "step", mesh=None, supervisor=None):
        if prefill not in ("step", "replay"):
            raise ValueError(
                f"prefill must be 'step' or 'replay', got {prefill!r}")
        if mesh is not None:
            raise NotImplementedError(
                "ContinuousBatcher: sharded serving (mesh) is not yet "
                "ported to repro_torch (ROADMAP queue A, item 11)")
        self.cfg = cfg
        self.b = batch_size
        self.max_seq = max_seq
        self.eos = eos_token
        self.prefill = prefill
        self.kv_dtype = kv_dtype
        self.supervisor = supervisor
        self.lut_tables = lut_tables
        self.params = params
        self.device = params.embed.device
        # a bf16 cache unless int8, whatever the model's dtype, as the
        # reference's cache_specs
        self.cache = init_cache(
            cfg, batch_size, max_seq, dtype=torch.bfloat16,
            device=self.device, kv_dtype="int8" if kv_dtype == "int8"
            else None)
        self._step = None
        self._build_step_fns()
        self.slots = [_Slot() for _ in range(batch_size)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.steps = 0
        self.active_slot_steps = 0
        self.replayed_tokens = 0
        self.submitted = 0
        self.table_swaps = 0

    def _build_step_fns(self) -> None:
        """One step for the tick and the replay (one capture on the card;
        a replay is T calls of it)."""
        if self._step is not None and hasattr(self._step, "reset"):
            self._step.reset()
        self._step = decode_fn(self.params, self.cfg, self.lut_tables)
        self._replay = lambda cache, toks: prefill_replay(
            self.params, self.cfg, cache, toks, 0, step=self._step)

    def swap_tables(self, lut_tables: dict | None,
                    cfg: ArchConfig | None = None) -> None:
        """Atomically swap the served plan (and optionally the patched
        config) between scheduler ticks: in-flight slots keep their cache
        rows and positions; only the step is rebuilt (and captured again
        on its next call)."""
        if cfg is not None:
            self.cfg = cfg
        self.lut_tables = lut_tables
        self._build_step_fns()
        self.table_swaps += 1

    def _guarded(self, thunk):
        """Run one serving call under the supervisor's fault policy: on an
        exception the supervisor may swap tables and have the call retried
        with the rebuilt step.  Bounded, so an unhandled repeated fault
        still surfaces."""
        for _ in range(6):
            try:
                return thunk()
            except Exception as e:
                if (self.supervisor is None
                        or not self.supervisor.on_fault(self, e)):
                    raise
        raise RuntimeError(
            "serving fault persisted after 6 supervised retries")

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError(
                f"request {req.rid}: empty prompt cannot be scheduled")
        req.t_submit = time.monotonic()
        self.submitted += 1
        self.queue.append(req)

    def _emit(self, req: Request, tok: int) -> None:
        req.out.append(tok)
        if req.t_first is None:
            req.t_first = time.monotonic()

    def _finish(self, slot: _Slot) -> None:
        req = slot.req
        req.done = True
        req.t_done = time.monotonic()
        self.finished.append(req)
        slot.req = None
        slot.pending = None

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                req = self.queue.popleft()
                slot.req = req
                slot.pos = 0
                slot.pending = list(req.prompt)
                if self.prefill == "replay" and len(slot.pending) > 1:
                    self._replay_slot(i, slot)

    def _tokens(self, columns: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(columns).to(self.device)

    def _replay_slot(self, i: int, slot: _Slot) -> None:
        """Ingest an admitted slot's whole prompt through the replayed
        decode step instead of one scheduler tick per token: the same
        write path (int8 entries and scales included) and the same LUT
        activations as decode.  A prompt that alone overflows the cache is
        truncated to ``max_seq`` ingested tokens and evicted without an
        output token, as on the step path."""
        req = slot.req
        truncated = len(slot.pending) > self.max_seq
        toks = slot.pending[:self.max_seq]
        n = len(toks)
        tokens = np.zeros((self.b, n), np.int64)
        tokens[i] = toks
        # the replay writes positions [0, n) for EVERY row; rows of other
        # slots must keep their entries: snapshot and restore
        others = [j for j in range(self.b) if j != i]
        snap = {name: self.cache[name][:, others, :n]
                for name in self.cache if name in _KV}
        logits, _ = self._guarded(lambda: self._replay(
            self.cache, self._tokens(tokens)))
        if others:
            for name, before in snap.items():
                self.cache[name][:, others, :n] = before
        slot.pos = n
        slot.pending = []
        self.replayed_tokens += n
        if truncated:
            self._finish(slot)
            return
        self._emit(req, int(torch.argmax(logits[i, -1])))
        if (slot.pos >= self.max_seq or len(req.out) >= req.max_new
                or req.out[-1] == self.eos):
            self._finish(slot)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def step(self) -> None:
        """One scheduler tick: each active slot ingests its next pending
        prompt token or decodes one new token."""
        self._admit()
        if self.n_active == 0:
            return
        tokens = np.zeros((self.b, 1), np.int64)
        for i, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            if slot.pending:
                tokens[i, 0] = slot.pending[0]
            elif slot.req.out:
                tokens[i, 0] = slot.req.out[-1]
            else:
                tokens[i, 0] = slot.req.prompt[-1]
        tokens = self._tokens(tokens)
        # one step call per distinct slot position
        by_pos: dict[int, list[int]] = {}
        for i, slot in enumerate(self.slots):
            if slot.req is not None:
                by_pos.setdefault(slot.pos, []).append(i)
        for pos, idxs in sorted(by_pos.items()):
            # a slot is evicted the moment its position reaches max_seq,
            # so every write lands strictly inside the cache
            assert pos < self.max_seq, (
                f"slot position {pos} out of cache bounds "
                f"(max_seq={self.max_seq}); eviction failed to fire")
            # the step writes cache index `pos` for EVERY row; rows outside
            # this position group must keep their entry
            others = [i for i in range(self.b) if i not in idxs]
            snap = {name: self.cache[name][:, others, pos]
                    for name in self.cache if name in _KV}
            # the step is looked up inside the thunk: a supervisor's fault
            # handler may swap tables, and the retry must run the new step
            logits, _ = self._guarded(
                lambda: self._step(self.cache, tokens, pos))
            if others:
                for name, before in snap.items():
                    self.cache[name][:, others, pos] = before
            nxt = torch.argmax(logits[:, -1], -1).tolist()
            for i in idxs:
                slot = self.slots[i]
                req = slot.req
                slot.pos += 1
                self.active_slot_steps += 1
                if slot.pending:
                    slot.pending.pop(0)
                    if not slot.pending:  # prompt done: first output token
                        self._emit(req, int(nxt[i]))
                else:
                    self._emit(req, int(nxt[i]))
                # slot.pos is the NEXT write index: the last row
                # (max_seq - 1) is usable, and a prompt that alone fills the
                # cache is truncated instead of writing out of bounds
                if (slot.pos >= self.max_seq
                        or (not slot.pending
                            and (len(req.out) >= req.max_new
                                 or req.out[-1] == self.eos))):
                    self._finish(slot)
        self.steps += 1

    def run(self, max_ticks: int = 10000,
            stall_ticks: int = 4) -> list[Request]:
        """Drive the scheduler until the queue drains (or ``max_ticks``).

        The supervisor's ``on_tick`` runs between ticks.  ``stall_ticks``
        consecutive ticks that neither finish a request, advance a slot
        nor replay prompt tokens mean some request can never be admitted
        or advanced: raise naming it instead of spinning to
        ``max_ticks``."""
        stalled = 0
        while (self.queue or self.n_active) and self.steps < max_ticks:
            if (self.supervisor is not None
                    and hasattr(self.supervisor, "on_tick")):
                self.supervisor.on_tick(self)
            before = (len(self.finished), self.active_slot_steps,
                      self.replayed_tokens)
            self.step()
            after = (len(self.finished), self.active_slot_steps,
                     self.replayed_tokens)
            stalled = stalled + 1 if after == before else 0
            if stalled >= stall_ticks:
                stuck = sorted(
                    [s.req.rid for s in self.slots if s.req is not None]
                    + [r.rid for r in self.queue])
                raise RuntimeError(
                    f"ContinuousBatcher stalled: no progress for "
                    f"{stalled} consecutive ticks with request id(s) "
                    f"{stuck} still unserved (batch_size={self.b}, "
                    f"max_seq={self.max_seq}) — the scheduler can never "
                    f"admit or advance them")
        return self.finished

    @property
    def utilization(self) -> float:
        """Mean fraction of slots doing useful work per tick."""
        if self.steps == 0:
            return 0.0
        return self.active_slot_steps / (self.steps * self.b)

    def metrics(self) -> dict:
        """Request accounting (anything submitted but neither finished,
        queued nor in flight counts as dropped), latency and TTFT
        percentiles over finished requests, and SLO violations."""
        lats = sorted(r.latency_s for r in self.finished
                      if r.latency_s is not None)
        ttfts = sorted(r.ttft_s for r in self.finished
                       if r.ttft_s is not None)

        def pct(xs: list, q: float) -> float:
            # nearest rank; 0.0 with nothing finished
            if not xs:
                return 0.0
            rank = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
            return float(xs[rank])

        slo = [r for r in self.finished if r.slo_ms is not None
               and r.latency_s is not None]
        return {
            "submitted": self.submitted,
            "finished": len(self.finished),
            "queued": len(self.queue),
            "active": self.n_active,
            "dropped": (self.submitted - len(self.finished)
                        - len(self.queue) - self.n_active),
            "ticks": self.steps,
            "utilization": self.utilization,
            "replayed_tokens": self.replayed_tokens,
            "table_swaps": self.table_swaps,
            "latency_p50_s": pct(lats, 0.50),
            "latency_p95_s": pct(lats, 0.95),
            "latency_max_s": float(lats[-1]) if lats else 0.0,
            "ttft_p50_s": pct(ttfts, 0.50),
            "slo_violations": sum(
                1 for r in slo if r.latency_s * 1e3 > r.slo_ms),
            "slo_tracked": len(slo),
        }
