"""Structured logger: human lines on stdout, events in the obs log (own
copy of the reference's ``obs/log.py``).

The launchers' replacement for bare ``print()``: every call names an
*event* plus a human-readable line; the line goes to stdout (stderr for
errors) exactly as before, and — when a telemetry context with an event
log is active (``launch/serve --obs-log``) — the same call lands as a
structured JSONL record with the machine-readable fields.  With no
telemetry active this is ``print()`` plus one ``None`` check.

    from repro_torch.obs.log import log
    log.info("prefill", f"prefill {b}x{t}: {dt:.2f}s", seconds=dt)

``Logger(out=fn)`` sends the human line to ``fn`` instead of the
standard streams (the launchers' ``log=`` arguments, which a caller may
point at its own log or silence); :func:`as_logger` makes one from such
an argument.
"""
from __future__ import annotations

import sys

from . import telemetry


class Logger:
    def __init__(self, out=None):
        self.out = out

    def _emit(self, level: str, event: str, msg: str | None,
              fields: dict) -> None:
        if msg is None:
            msg = " ".join(f"{k}={v}" for k, v in fields.items())
        if self.out is not None:
            self.out(msg)
        else:
            stream = sys.stderr if level == "error" else sys.stdout
            print(msg, file=stream)
        t = telemetry.current()
        if t is not None and t.events is not None:
            t.events.emit(event, level=level, msg=msg, **fields)

    def info(self, event: str, msg: str | None = None, **fields) -> None:
        self._emit("info", event, msg, fields)

    def warn(self, event: str, msg: str | None = None, **fields) -> None:
        self._emit("warn", event, msg, fields)

    def error(self, event: str, msg: str | None = None, **fields) -> None:
        self._emit("error", event, msg, fields)


log = Logger()


def as_logger(out=None) -> Logger:
    """``out`` as a :class:`Logger`: the module's :data:`log` for
    ``None`` or ``print``, a logger as it is, else one that sends its
    lines to the callable ``out``."""
    if out is None or out is print:
        return log
    if isinstance(out, Logger):
        return out
    return Logger(out)
