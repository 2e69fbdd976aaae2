"""Unified telemetry: metrics registry, event timeline, drift monitor
(PyTorch port of the reference's ``obs`` package, with its ``__all__``).

The serving stack's eyes (the observability layer the online retune loop
consumes):

* :mod:`.metrics` — labeled counters/gauges/exponential-bucket
  histograms with a Prometheus text exposition;
* :mod:`.events` — checksummed JSONL event log (``repro-obs/v1``) with
  nested spans and sampling for high-frequency events;
* :mod:`.drift` — the don't-care hit-rate monitor (served lookups
  landing in don't-care bins of the active plan's care masks), counted
  on the device so that a monitored step is captured in a CUDA graph;
* :mod:`.telemetry` — the context binding them, with module-level
  no-op-when-inactive helpers (``obs.event``/``obs.span``/``obs.count``)
  the instrumented layers call;
* :mod:`.log` — the structured stdout-mirroring logger the launchers
  print through.

Everything is off by default: no context entered means one ``None``
check per host hook and no kernel added to a served step.
"""
from .drift import DontCareMonitor, monitor_active, suppressed
from .events import OBS_SCHEMA, EventLog, read_events, record_crc
from .log import Logger, log
from .metrics import (
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    exponential_buckets,
)
from .telemetry import (
    Telemetry,
    count,
    current,
    event,
    gauge,
    kernel_launch,
    observe,
    span,
    telemetry_active,
)

__all__ = [
    "DontCareMonitor",
    "monitor_active",
    "suppressed",
    "OBS_SCHEMA",
    "EventLog",
    "read_events",
    "record_crc",
    "Logger",
    "log",
    "LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "exponential_buckets",
    "Telemetry",
    "count",
    "current",
    "event",
    "gauge",
    "kernel_launch",
    "observe",
    "span",
    "telemetry_active",
]
