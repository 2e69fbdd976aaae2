"""Telemetry context: one object binding registry + event log + monitor
(own copy of the reference's ``obs/telemetry.py``).

The activation idiom is :mod:`repro_torch.calib.capture`'s module-level
stack: instrumented code (batcher, reloader, ladder, engine, kernel
wrappers) asks :func:`current` for the innermost active
:class:`Telemetry` and does nothing when there is none — off-by-default
telemetry costs one ``None`` check on host code paths and adds **no
kernel** to a served step (the don't-care monitor's counting ops only run
while its context is entered; tests/test_torch_obs_serve.py compares the
step's op lists).

Entering a :class:`Telemetry` also enters its
:class:`~repro_torch.obs.drift.DontCareMonitor` (when attached); exiting
reads the monitor's device counters back once, emits one ``drift`` event
per observed site key, writes the metrics snapshot into the event log's
``obs_end`` footer, and optionally dumps the Prometheus text exposition
to ``prom_path`` (atomic tmp + replace, the ioutil write discipline).

``kernel_launches_total{backend,kernel}`` differs from the reference's.
The reference counts trace-time wrapper invocations: one per compiled
trace of a step, not one per executed launch.  A replayed CUDA graph runs
no Python, so counting wrapper calls here would count captures.  The port
counts what :func:`repro_torch.kernels.launch_counts` counts instead —
every eager launch, plus the launches a captured step recorded, added at
each replay (:class:`repro_torch.serve.graphs.CapturedStep`) — and the
gather evaluator's calls join that tally (``gather:*`` points, counted
the same way).  The counter is a report: nothing decides on it (the
degradation ladder probes sites itself).
"""
from __future__ import annotations

import os
from contextlib import nullcontext

from .drift import DontCareMonitor
from .events import EventLog
from .metrics import MetricsRegistry

_STACK: list["Telemetry"] = []


def telemetry_active() -> bool:
    return bool(_STACK)


def current() -> "Telemetry | None":
    return _STACK[-1] if _STACK else None


class Telemetry:
    """Registry + event log + (optional) don't-care monitor, as one
    context.  All pieces are optional; a bare ``Telemetry()`` records
    metrics in memory only."""

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 events: EventLog | None = None,
                 monitor: DontCareMonitor | None = None,
                 prom_path: str | None = None):
        self.registry = registry or MetricsRegistry()
        self.events = events
        self.monitor = monitor
        self.prom_path = prom_path
        self._entered = False
        self._monitor_entered = False
        self._finished = False

    # -- context management --------------------------------------------------
    def __enter__(self) -> "Telemetry":
        _STACK.append(self)
        self._entered = True
        if self.monitor is not None and not self._monitor_entered:
            self.monitor.__enter__()
            self._monitor_entered = True
        return self

    def __exit__(self, *exc) -> None:
        _STACK.remove(self)
        self._entered = False
        self.finish()

    def attach_monitor(self, monitor: DontCareMonitor) -> None:
        """Late-bind a drift monitor (the launcher learns its calibration
        after telemetry starts); activates it if we are already entered."""
        self.monitor = monitor
        if self._entered and not self._monitor_entered:
            monitor.__enter__()
            self._monitor_entered = True

    def finish(self) -> None:
        """Flush + export: drift events, metrics footer, Prometheus dump.
        Idempotent; runs automatically on context exit."""
        if self._finished:
            return
        self._finished = True
        if self._monitor_entered:
            self.monitor.__exit__(None, None, None)
            self._monitor_entered = False
        if self.monitor is not None:
            for key, row in self.monitor.drift().items():
                self.event("drift", site=key, **row)
                self.registry.gauge(
                    "lut_dontcare_served_frac",
                    "served lookup fraction landing in don't-care bins",
                ).set(row["served_dontcare_frac"], site=key)
        if self.events is not None:
            self.events.close(metrics=self.registry.snapshot())
        if self.prom_path is not None:
            tmp = self.prom_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(self.registry.render_prometheus())
            os.replace(tmp, self.prom_path)

    # -- convenience ---------------------------------------------------------
    def event(self, name: str, *, sampled: bool = False, **fields) -> None:
        if self.events is not None:
            self.events.emit(name, sampled=sampled, **fields)

    def span(self, name: str, **fields):
        if self.events is not None:
            return self.events.span(name, **fields)
        return nullcontext()


# -- module-level no-op-when-inactive helpers --------------------------------
def event(name: str, *, sampled: bool = False, **fields) -> None:
    t = current()
    if t is not None:
        t.event(name, sampled=sampled, **fields)


def span(name: str, **fields):
    t = current()
    if t is not None:
        return t.span(name, **fields)
    return nullcontext()


def count(name: str, amount: float = 1.0, help: str = "", **labels) -> None:
    t = current()
    if t is not None:
        t.registry.counter(name, help).inc(amount, **labels)


def gauge(name: str, value: float, help: str = "", **labels) -> None:
    t = current()
    if t is not None:
        t.registry.gauge(name, help).set(value, **labels)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    t = current()
    if t is not None:
        t.registry.histogram(name, help).observe(value, **labels)


def kernel_launch(point: str, n: int = 1) -> None:
    """Per-backend kernel launch counter (``"backend:kernel"`` points):
    ``n`` launches of ``point`` (see the module docstring for what is
    counted and how it differs from the reference's trace-time count)."""
    t = current()
    if t is not None and n > 0:
        backend, _, kern = point.partition(":")
        t.registry.counter(
            "kernel_launches_total",
            "kernel launches by backend (eager and graph replays)",
        ).inc(n, backend=backend, kernel=kern)
