"""Gated hot plan reload: swap a tuned plan into a running batcher
(PyTorch port of the reference's ``serve/reload.py``).

The closing piece of the capture -> tune -> serve loop: a freshly tuned
``.npz`` plan artifact (bit-exact, recompression-free,
:mod:`repro_torch.tune.artifact`, either package's) is brought into a
*running* :class:`~repro_torch.serve.batching.ContinuousBatcher` without
dropping a request.  The protocol:

1. **Shadow build** — load the artifact (integrity-checksummed;
   corrupt/truncated files are rejected here) and build its serving
   tables off the hot path.  Arch/depth binding is enforced by
   ``TunedPlan.patched_config``.
2. **Parity gate** — evaluate the candidate against the *active* plan on
   held shadow batches with :class:`~repro_torch.tune.parity.
   ParityHarness` (top-1 agreement) plus a greedy-token identity probe.
   The gate judges the plan's *values* on the gather form, the
   backend-agnostic semantics every rung is bit-identical to;
   kernel-level health is the degradation ladder's job.  The paper's
   contract (≤ 0.01 accuracy drop for a ReducedLUT compression) becomes
   a serving invariant: a plan that would degrade tokens beyond the
   budget never cuts over.
3. **Atomic cutover** — between scheduler ticks (the supervisor's
   ``on_tick``), :meth:`~ContinuousBatcher.swap_tables` replaces the
   tables and the step (captured again on its next call); in-flight
   slots keep their cache rows.
4. **Probation + rollback** — a step fault within ``probation_ticks`` of
   cutover rolls back to the previous plan/config and schedules a
   bounded retry with doubling backoff.

Every decision is recorded as a :class:`ReloadRecord` (the control
plane's audit log) and counted in :attr:`PlanReloader.counters`, and
lands in the telemetry as the reference's ``reloads_total{stage,ok}``
counter and ``reload_*`` events (:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import dataclasses
import os
import time

from repro_torch import obs

from . import faults


@dataclasses.dataclass
class ReloadRecord:
    """One reload attempt: what happened, where, and why."""

    path: str
    ok: bool
    stage: str                 # loaded|gate|cutover|rollback|timeout
    reason: str | None = None
    top1_drop: float | None = None
    token_agreement: float | None = None
    load_s: float = 0.0
    gate_s: float = 0.0
    tick: int | None = None

    def summary(self) -> str:
        if self.ok:
            return (f"reload {self.path}: cut over at tick {self.tick} "
                    f"(top-1 drop {self.top1_drop:.4f}, token agreement "
                    f"{self.token_agreement:.3f}; load {self.load_s:.2f}s, "
                    f"gate {self.gate_s:.2f}s)")
        return (f"reload {self.path}: REJECTED at {self.stage} — "
                f"{self.reason}")


class PlanReloader:
    """Hot-reload tuned plans into a running batcher behind a parity gate.

    Drive it as the batcher's supervisor (or inside a
    :class:`~repro_torch.serve.degrade.CompositeSupervisor`, ahead of the
    ladder): :meth:`schedule` arms a one-shot reload at a tick,
    :meth:`watch` polls an artifact path's mtime every tick, and
    :meth:`reload` runs the full gate synchronously between ticks.
    """

    def __init__(self, batcher, cfg, params, *, backend: str | None = None,
                 plan_exec: str = "stacked", kernel: str | None = None,
                 shadow_batches: list | None = None, gate_tokens: int = 4,
                 max_top1_drop: float = 0.01,
                 min_token_agreement: float = 1.0,
                 timeout_s: float | None = None, probation_ticks: int = 8,
                 max_retries: int = 1, retry_backoff_ticks: int = 8,
                 ladder=None):
        self.batcher = batcher
        self.cfg = cfg                 # active serving config
        self.params = params
        if backend is None:
            active = batcher.lut_tables
            backend = (active or {}).get("backend", "gather")
        self.backend = backend
        self.plan_exec = plan_exec
        self.kernel = kernel
        self.gate_tokens = gate_tokens
        self.max_top1_drop = max_top1_drop
        self.min_token_agreement = min_token_agreement
        self.timeout_s = timeout_s
        self.probation_ticks = probation_ticks
        self.max_retries = max_retries
        self.retry_backoff_ticks = retry_backoff_ticks
        self.ladder = ladder
        self._shadow = shadow_batches
        self.records: list[ReloadRecord] = []
        self.counters = {"reloads_ok": 0, "rejected_load": 0,
                         "rejected_gate": 0, "rejected_timeout": 0,
                         "rollbacks": 0, "retries_scheduled": 0}
        self._pending: tuple[str, int, int] | None = None  # path, tick, retry
        self._retry_count = 0      # retry generation of the *next* reload
        self._watch_path: str | None = None
        self._watch_mtime: float | None = None
        self._probation: dict | None = None

    # -- shadow batches -----------------------------------------------------
    def shadow_batches(self) -> list:
        """Held batches the gate scores on — disjoint from training data
        (:func:`repro_torch.tune.parity.heldout_batches`), built lazily
        once."""
        if self._shadow is None:
            from repro_torch.tune.parity import heldout_batches

            self._shadow = heldout_batches(self.cfg, steps=2,
                                           batch_size=2, seq_len=8,
                                           seed=23)
        return self._shadow

    # -- arming -------------------------------------------------------------
    def schedule(self, path: str, at_tick: int) -> None:
        """Arm a one-shot reload of ``path`` once ``batcher.steps``
        reaches ``at_tick`` (fires from ``on_tick``, between ticks)."""
        self._pending = (path, at_tick, 0)

    def watch(self, path: str) -> None:
        """Poll ``path`` every tick; any mtime change triggers a reload
        — the launcher's ``--watch`` mode for retune pipelines that drop
        fresh artifacts next to the server."""
        self._watch_path = path
        try:
            self._watch_mtime = os.stat(path).st_mtime
        except OSError:
            self._watch_mtime = None

    # -- the gate -----------------------------------------------------------
    def _reject(self, rec: ReloadRecord, counter: str) -> ReloadRecord:
        self.records.append(rec)
        self.counters[counter] += 1
        self._retry_count = 0
        obs.count("reloads_total", stage=rec.stage, ok="false")
        obs.event("reload_reject", path=rec.path, stage=rec.stage,
                  reason=rec.reason)
        return rec

    def reload(self, path: str) -> ReloadRecord:
        """Run the full reload protocol for ``path`` now.  Never raises:
        every failure mode becomes a rejection record and the active
        plan keeps serving."""
        t0 = time.monotonic()
        obs.event("reload_attempt", path=path, tick=self.batcher.steps)
        try:
            faults.fault_point("reload:load")
            from repro_torch.tune import load_tuned_plan

            tp = load_tuned_plan(path)
            new_cfg = tp.patched_config(self.cfg)
        except Exception as e:
            return self._reject(
                ReloadRecord(path, False, "load",
                             f"{type(e).__name__}: {e}",
                             load_s=time.monotonic() - t0),
                "rejected_load")
        load_s = time.monotonic() - t0
        if self.timeout_s is not None and load_s > self.timeout_s:
            return self._reject(
                ReloadRecord(path, False, "timeout",
                             f"artifact load took {load_s:.2f}s "
                             f"(timeout {self.timeout_s:.2f}s) — "
                             f"slow/stuck reload aborted", load_s=load_s),
                "rejected_timeout")

        # Shadow-build + parity gate.  The gate always scores the gather
        # form: the candidate's *values* are what the budget bounds, and
        # every serving rung is bit-identical to gather — a plan whose
        # kernels fault still gates clean here and is then caught by
        # probation/rollback (or the ladder) after cutover.
        t1 = time.monotonic()
        try:
            from repro_torch.tune.parity import ParityHarness, greedy_tokens

            gate_tables = tp.tables_for_model(backend="gather",
                                              plan_exec=self.plan_exec,
                                              device=self.batcher.device)
            active = self.batcher.lut_tables
            batches = self.shadow_batches()
            harness = ParityHarness(self.cfg, self.params, batches,
                                    ref_tables=active)
            metrics = harness.evaluate(gate_tables)
            ref_toks = greedy_tokens(self.cfg, self.params, batches[0],
                                     self.gate_tokens, active)
            new_toks = greedy_tokens(new_cfg, self.params, batches[0],
                                     self.gate_tokens, gate_tables)
            flat_ref = [t for row in ref_toks for t in row]
            flat_new = [t for row in new_toks for t in row]
            agreement = (sum(a == b for a, b in zip(flat_ref, flat_new))
                         / max(1, len(flat_ref)))
        except Exception as e:
            return self._reject(
                ReloadRecord(path, False, "gate",
                             f"shadow evaluation failed: "
                             f"{type(e).__name__}: {e}", load_s=load_s,
                             gate_s=time.monotonic() - t1),
                "rejected_gate")
        gate_s = time.monotonic() - t1
        elapsed = time.monotonic() - t0
        if self.timeout_s is not None and elapsed > self.timeout_s:
            return self._reject(
                ReloadRecord(path, False, "timeout",
                             f"reload took {elapsed:.2f}s (timeout "
                             f"{self.timeout_s:.2f}s) — slow/stuck "
                             f"reload aborted", load_s=load_s,
                             gate_s=gate_s),
                "rejected_timeout")
        if (metrics.top1_drop > self.max_top1_drop
                or agreement < self.min_token_agreement):
            return self._reject(
                ReloadRecord(path, False, "gate",
                             f"parity gate failed: top-1 drop "
                             f"{metrics.top1_drop:.4f} (max "
                             f"{self.max_top1_drop}), token agreement "
                             f"{agreement:.3f} (min "
                             f"{self.min_token_agreement})",
                             top1_drop=metrics.top1_drop,
                             token_agreement=agreement,
                             load_s=load_s, gate_s=gate_s),
                "rejected_gate")

        # Atomic cutover (we are between ticks) + probation arming.
        retries = self._retry_count
        self._retry_count = 0
        prev = {"tables": self.batcher.lut_tables, "cfg": self.batcher.cfg,
                "ladder_source": (self.ladder.source
                                  if self.ladder is not None else None)}
        if self.ladder is not None:
            self.ladder.rebind(tp, plan_exec=self.plan_exec)
            serve_tables = self.ladder.tables()
        else:
            serve_tables = tp.tables_for_model(backend=self.backend,
                                               plan_exec=self.plan_exec,
                                               kernel=self.kernel,
                                               device=self.batcher.device)
        self.batcher.swap_tables(serve_tables, cfg=new_cfg)
        self.cfg = new_cfg
        self._probation = {
            "until": self.batcher.steps + self.probation_ticks,
            "prev": prev, "path": path, "retries": retries,
        }
        self.counters["reloads_ok"] += 1
        rec = ReloadRecord(path, True, "cutover",
                           top1_drop=metrics.top1_drop,
                           token_agreement=agreement, load_s=load_s,
                           gate_s=gate_s, tick=self.batcher.steps)
        self.records.append(rec)
        obs.count("reloads_total", stage="cutover", ok="true")
        obs.event("reload_cutover", path=path, tick=rec.tick,
                  top1_drop=round(metrics.top1_drop, 6),
                  token_agreement=round(agreement, 4),
                  load_s=round(load_s, 4), gate_s=round(gate_s, 4))
        return rec

    # -- batcher supervisor protocol ---------------------------------------
    def on_tick(self, batcher) -> None:
        if self._watch_path is not None:
            try:
                mtime = os.stat(self._watch_path).st_mtime
            except OSError:
                mtime = None
            if mtime is not None and mtime != self._watch_mtime:
                self._watch_mtime = mtime
                self.reload(self._watch_path)
        if self._pending is not None and batcher.steps >= self._pending[1]:
            path, _, retries = self._pending
            self._pending = None
            self._retry_count = retries
            self.reload(path)
        if (self._probation is not None
                and batcher.steps > self._probation["until"]):
            self._probation = None   # survived probation

    def on_fault(self, batcher, exc) -> bool:
        """Probation rollback: a fault shortly after cutover restores the
        previous plan/config and schedules a bounded retry."""
        p = self._probation
        if p is None or batcher.steps > p["until"]:
            return False
        prev = p["prev"]
        if self.ladder is not None and prev["ladder_source"] is not None:
            self.ladder.rebind(prev["ladder_source"])
        batcher.swap_tables(prev["tables"], cfg=prev["cfg"])
        self.cfg = prev["cfg"]
        self.counters["rollbacks"] += 1
        self.records.append(ReloadRecord(
            p["path"], False, "rollback",
            f"post-cutover fault: {type(exc).__name__}: {exc} — "
            f"previous plan restored", tick=batcher.steps))
        obs.count("reloads_total", stage="rollback", ok="false")
        obs.event("reload_rollback", path=p["path"], tick=batcher.steps,
                  reason=f"{type(exc).__name__}: {exc}")
        if p["retries"] < self.max_retries:
            delay = self.retry_backoff_ticks * (2 ** p["retries"])
            self._pending = (p["path"], batcher.steps + delay,
                             p["retries"] + 1)
            self.counters["retries_scheduled"] += 1
            obs.event("reload_retry_scheduled", path=p["path"],
                      at_tick=batcher.steps + delay,
                      retry=p["retries"] + 1)
        self._probation = None
        return True
