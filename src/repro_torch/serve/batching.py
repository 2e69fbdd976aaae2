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
on the card, eager on the CPU.  The reference's telemetry is ported
(:mod:`repro_torch.obs`): table swaps and serving faults as counters and
events, the tick counters, gauges and ``batcher_tick_s``, request latency
and TTFT histograms, the ``prefill_replay`` span.  With a don't-care
monitor active the batcher keeps two steps, the monitored one and a plain
one run under ``suppressed()`` (two CUDA graphs sharing one memory pool
on the card), and a tick takes the monitored one on every
``sample_every``-th tick (:meth:`ContinuousBatcher._pick_step`).  A
replay prefill is T calls of the step here, where the reference's is one
program traced under the monitor, so the replay runs the monitored step
for every prompt token: per-key lookups then equal the reference's for
the same traffic.

With a ``mesh`` (:mod:`repro_torch.launch.mesh`) every rank runs the same
scheduler over the same requests; the pool's rows split over the data
axis (B / dp slots a rank, in order), the steps are a
:class:`~.sharded.ShardedServe`'s, each tick gathers the weights once
into the same buffers, and the ranks' next tokens are gathered over the
data axis so that every rank's scheduler sees every slot's token.  With
a card a rank (NCCL) the step and the replay run through the captured
sharded step (:class:`~.sharded.ShardedCapturedStep`, two sharing one
pool as above); ranks sharing a card (gloo, whose collectives cannot be
captured) step eagerly.

The batcher serves the dense and moe families and refuses the others
(:data:`REFUSED`), whose reference batcher answers wrongly: its snapshot
and restore cover only the top-level attention cache, so an ssm (RWKV6)
step, which advances every row's recurrent state, and a hybrid step,
which advances its nested rings, conv windows and LRU vectors, would
advance a row twice in a tick with slots at two positions, and idle
slots too; vlm requests would carry no patches; an encdec slot would
decode against zero cross K/V, since no encoder pass runs.  A moe step
routes all B rows together, so a row's
experts could see another row's tokens only through a dropped
assignment; at decode no expert sees more tokens than rows, and with
capacity >= B (8 at 4 slots on both moe configurations, at least 2B on
their smoke configs) nothing is dropped and rows stay independent, as in
the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.obs import drift as obs_drift

from .decode import prefill_replay
from .graphs import decode_fn
from .kvcache import init_cache

# the cache entries a step writes at its position for every row
_KV = ("k", "v", "k_scale", "v_scale")

# the families the batcher refuses, and the reference caveat behind each
REFUSED = {
    "ssm": "its snapshot covers only top-level k / v, so a tick with slots "
           "at two positions advances a row's recurrent state twice and "
           "idle slots advance too (repro/serve/batching.py:286-289, "
           "356-359)",
    "hybrid": "its snapshot covers only top-level k / v, so a tick with "
              "slots at two positions advances a row's rings, conv windows "
              "and LRU vectors twice and idle slots advance too "
              "(repro/serve/batching.py:286-289, 356-359)",
    "vlm": "a request carries no patches, so the image prefix is lost",
    "encdec": "no encoder pass runs, so every slot decodes against zero "
              "cross K/V",
}


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
        if cfg.family in REFUSED:
            raise NotImplementedError(
                f"ContinuousBatcher serves the dense and moe families, not "
                f"{cfg.family!r}: {REFUSED[cfg.family]}")
        self.cfg = cfg
        self.mesh = mesh
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
        self._rows = list(range(batch_size))   # the pool rows held here
        self._serve = None
        if mesh is not None:
            from .sharded import batch_placement

            self._rows = batch_placement(
                mesh, {"i": torch.arange(batch_size)})["i"].tolist()
        self._step = self._step_plain = None
        # the monitored and the plain step capture into one memory pool
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._build_step_fns()
        if mesh is not None:
            self.params = self._serve.place_params(params)
            self.cache = self._serve.place_cache(self.cache)
        self.slots = [_Slot() for _ in range(batch_size)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.steps = 0
        self.active_slot_steps = 0
        self.replayed_tokens = 0
        self.submitted = 0
        self.table_swaps = 0

    def _build_step_fns(self) -> None:
        """The step for the tick and the replay (one capture on the card;
        a replay is T calls of it, under the ambient monitor), and the
        plain step the ticks a drift monitor does not sample take: the
        same step run under ``suppressed()``, captured on first use."""
        for step in (self._step, self._step_plain):
            if step is not None and hasattr(step, "reset"):
                step.reset()
        if self.mesh is not None:
            from .sharded import ShardedServe, capture_refusal

            serve = self._serve = ShardedServe(
                self.cfg, self.mesh, self.lut_tables, kv_dtype=self.kv_dtype)
            self.lut_tables = serve.tables
            if capture_refusal(self.mesh) is None:
                # NCCL on the card: the captured steps over the session's
                # weights, which every tick gathers into the same buffers
                self._step = serve.decode_fn(None, pool=self._pool)
                self._step_plain = serve.decode_fn(None, pool=self._pool)
            else:
                self._step = self._step_plain = (
                    lambda cache, toks, pos: serve.decode(self.params, cache,
                                                          toks, pos))
            self._replay = lambda cache, toks: prefill_replay(
                None, self.cfg, cache, toks, 0, step=self._step)
            return
        self._step = decode_fn(self.params, self.cfg, self.lut_tables,
                               pool=self._pool)
        self._step_plain = decode_fn(self.params, self.cfg,
                                     self.lut_tables, pool=self._pool)
        self._replay = lambda cache, toks: prefill_replay(
            self.params, self.cfg, cache, toks, 0, step=self._step)

    def _plain(self, cache, tokens, pos):
        with obs_drift.suppressed():
            return self._step_plain(cache, tokens, pos)

    def _pick_step(self):
        """The step for this tick: the monitored step on every
        ``sample_every``-th tick while a drift monitor is active, the
        plain step otherwise."""
        mon = obs_drift.current()
        if mon is not None and self.steps % mon.sample_every != 0:
            return self._plain
        return self._step

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
        obs.count("batcher_table_swaps_total")
        obs.event("table_swap", tick=self.steps, swaps=self.table_swaps,
                  backend=(lut_tables or {}).get("backend", "float"))

    def _guarded(self, thunk):
        """Run one serving call under the supervisor's fault policy: on an
        exception the supervisor may swap tables and have the call retried
        with the rebuilt step.  Bounded, so an unhandled repeated fault
        still surfaces."""
        for _ in range(6):
            try:
                return thunk()
            except Exception as e:
                obs.count("serve_faults_total")
                obs.event("serve_fault", tick=self.steps,
                          error=f"{type(e).__name__}: {e}")
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
        t = obs.current()
        if t is not None:
            # latency / TTFT land in registry histograms (the exportable
            # form) beside the raw per-request stamps metrics() reads
            if req.latency_s is not None:
                t.registry.histogram(
                    "serve_request_latency_s",
                    "submit-to-eviction request latency").observe(
                    req.latency_s)
            if req.ttft_s is not None:
                t.registry.histogram(
                    "serve_request_ttft_s",
                    "submit-to-first-token latency").observe(req.ttft_s)
            t.event("request_finish", rid=req.rid, tokens=len(req.out),
                    latency_s=(None if req.latency_s is None
                               else round(req.latency_s, 6)),
                    ttft_s=(None if req.ttft_s is None
                            else round(req.ttft_s, 6)))

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
        """This rank's rows of the pool's token columns, on its device."""
        return torch.as_tensor(columns[self._rows]).to(self.device)

    def _local(self, rows: list[int]) -> list[int]:
        """This rank's cache rows among the pool rows ``rows``."""
        mine = {r: i for i, r in enumerate(self._rows)}
        return [mine[r] for r in rows if r in mine]

    def _next_tokens(self, logits: torch.Tensor) -> list[int]:
        """The greedy next token of every pool row, from this rank's
        rows' last-position logits (gathered over the data axis under a
        mesh)."""
        nxt = torch.argmax(logits[:, -1], -1)
        if self.mesh is not None:
            from .sharded import gather_rows

            nxt = gather_rows(nxt, self.mesh)
        return nxt.tolist()

    def _tick(self):
        """One gather of the weights for a tick's steps under a mesh."""
        if self._serve is None:
            return contextlib.nullcontext()
        return self._serve.session(self.params)

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
        with obs.span("prefill_replay", rid=req.rid, tokens=n):
            self._replay_slot_body(i, slot, req, truncated, toks, n)

    def _replay_slot_body(self, i, slot, req, truncated, toks, n) -> None:
        tokens = np.zeros((self.b, n), np.int64)
        tokens[i] = toks
        # the replay writes positions [0, n) for EVERY row; rows of other
        # slots must keep their entries: snapshot and restore
        others = self._local([j for j in range(self.b) if j != i])
        snap = {name: self.cache[name][:, others, :n]
                for name in self.cache if name in _KV}
        logits, _ = self._guarded(lambda: self._replay(
            self.cache, self._tokens(tokens)))
        if others:
            for name, before in snap.items():
                self.cache[name][:, others, :n] = before
        nxt = self._next_tokens(logits)
        slot.pos = n
        slot.pending = []
        self.replayed_tokens += n
        if truncated:
            self._finish(slot)
            return
        self._emit(req, int(nxt[i]))
        if (slot.pos >= self.max_seq or len(req.out) >= req.max_new
                or req.out[-1] == self.eos):
            self._finish(slot)

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def step(self) -> None:
        """One scheduler tick: each active slot ingests its next pending
        prompt token or decodes one new token.  Tick telemetry (queue
        depth, slot utilization, tick duration) is recorded per tick in
        the registry and as *sampled* timeline events — ``--obs-sample``
        thins the per-tick records, never the gauges/counters."""
        t = obs.current()
        t0 = time.monotonic() if t is not None else 0.0
        with self._tick():
            self._admit()
            if self.n_active == 0:
                return
            self._step_slots()
        self.steps += 1
        if t is not None:
            r = t.registry
            r.counter("batcher_ticks_total").inc()
            r.gauge("batcher_queue_depth").set(len(self.queue))
            r.gauge("batcher_active_slots").set(self.n_active)
            r.gauge("batcher_slot_utilization").set(self.utilization)
            r.histogram("batcher_tick_s", "scheduler tick duration"
                        ).observe(time.monotonic() - t0)
            t.event("tick", sampled=True, tick=self.steps,
                    queued=len(self.queue), active=self.n_active,
                    dur_s=round(time.monotonic() - t0, 6))

    def _step_slots(self) -> None:
        """A tick's step calls: one per distinct slot position."""
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
            others = self._local([i for i in range(self.b) if i not in idxs])
            snap = {name: self.cache[name][:, others, pos]
                    for name in self.cache if name in _KV}
            # the step is looked up inside the thunk: a supervisor's fault
            # handler may swap tables, and the retry must run the new step
            logits, _ = self._guarded(
                lambda: self._pick_step()(self.cache, tokens, pos))
            if others:
                for name, before in snap.items():
                    self.cache[name][:, others, pos] = before
            nxt = self._next_tokens(logits)
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
