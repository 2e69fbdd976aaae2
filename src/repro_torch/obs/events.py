"""Structured JSONL event log with nested spans and per-line checksums
(own copy of the reference's ``obs/events.py``: the canonical JSON and
the CRC rule are the reference's, so either package reads the other's
log).

Schema ``repro-obs/v1``: line 1 is a header record carrying the schema
tag, every line is one JSON object with a ``crc`` field (CRC32 over the
canonical JSON of the record without it — the :mod:`repro_torch.ioutil`
artifact-integrity discipline adapted from whole-file atomicity to an
append-only stream), and a cleanly closed log ends with an ``obs_end``
footer carrying the record count.  :func:`read_events` hard-fails on a
bit-flipped line, a missing header, or (strict mode) a truncated log,
raising the same :class:`repro_torch.ioutil.ArtifactError` the npz artifacts
use.

Record shape::

    {"seq": N, "t": seconds-since-start, "event": "...",
     ["span": enclosing-span-id,] ...fields..., "crc": CRC32}

Spans (:meth:`EventLog.span`) emit paired ``span_begin``/``span_end``
records sharing a ``span_id``; nesting is recorded via ``parent`` on
``span_begin`` and the ``span`` field stamped on every record emitted
inside.  High-frequency events (scheduler ticks) pass ``sampled=True``
and are thinned to one record per ``sample`` occurrences per event name,
with the number of dropped occurrences carried on the surviving record —
the log never silently under-reports.
"""
from __future__ import annotations

import json
import time
import zlib
from contextlib import contextmanager

from repro_torch.ioutil import ArtifactError

OBS_SCHEMA = "repro-obs/v1"


def _canonical(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"),
                      default=str)


def record_crc(rec: dict) -> int:
    """CRC32 over the canonical JSON of ``rec`` without its ``crc``."""
    body = {k: v for k, v in rec.items() if k != "crc"}
    return zlib.crc32(_canonical(body).encode("utf-8")) & 0xFFFFFFFF


class EventLog:
    """Append-only in-memory + optional on-disk JSONL event stream."""

    def __init__(self, path: str | None = None, *, sample: int = 1):
        self.path = path
        self.sample = max(1, int(sample))
        self.records: list[dict] = []
        self._seq = 0
        self._t0 = time.time()
        self._spans: list[str] = []       # open span ids, innermost last
        self._span_n = 0
        self._seen: dict[str, int] = {}     # sampled event -> occurrences
        self._dropped: dict[str, int] = {}  # sampled event -> skips pending
        self._fh = open(path, "a", encoding="utf-8") if path else None
        self._closed = False
        self._write({"event": "obs_start", "schema": OBS_SCHEMA,
                     "wall_time": round(self._t0, 3)})

    # -- write path ---------------------------------------------------------
    def _write(self, rec: dict) -> dict:
        rec = {"seq": self._seq, "t": round(time.time() - self._t0, 6),
               **rec}
        # Round-trip through JSON first so the CRC is computed on exactly
        # the value a reader will parse back (non-JSON field values are
        # stringified once, here, not differently on each side).
        rec = json.loads(_canonical(rec))
        rec["crc"] = record_crc(rec)
        self._seq += 1
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(_canonical(rec) + "\n")
            self._fh.flush()
        return rec

    def emit(self, event: str, *, sampled: bool = False,
             **fields) -> dict | None:
        """Append one event record; returns it, or ``None`` when a
        sampled event was thinned out this occurrence."""
        if self._closed:
            return None
        if sampled and self.sample > 1:
            seen = self._seen.get(event, 0)
            self._seen[event] = seen + 1
            if seen % self.sample:
                self._dropped[event] = self._dropped.get(event, 0) + 1
                return None
            pending = self._dropped.pop(event, 0)
            if pending:
                fields["sampled_dropped"] = pending
                fields["sampled_every"] = self.sample
        rec = {"event": event}
        if self._spans:
            rec["span"] = self._spans[-1]
        rec.update(fields)
        return self._write(rec)

    @contextmanager
    def span(self, name: str, **fields):
        """Nested timed span: ``span_begin``/``span_end`` records share a
        ``span_id``; records emitted inside carry it in ``span``."""
        sid = f"s{self._span_n}"
        self._span_n += 1
        parent = self._spans[-1] if self._spans else None
        t0 = time.time()
        self.emit("span_begin", span_id=sid,
                  **({"parent": parent} if parent else {}),
                  name=name, **fields)
        self._spans.append(sid)
        try:
            yield sid
        finally:
            self._spans.pop()
            self.emit("span_end", span_id=sid, name=name,
                      dur_s=round(time.time() - t0, 6))

    def close(self, **fields) -> None:
        """Write the ``obs_end`` footer (record count + final payload,
        e.g. the metrics snapshot) and release the file handle."""
        if self._closed:
            return
        for event, pending in sorted(self._dropped.items()):
            if pending:
                self.emit(event, sampled_dropped=pending,
                          sampled_every=self.sample, final=True)
        self._write({"event": "obs_end",
                     "n_records": len(self.records) + 1, **fields})
        self._closed = True
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_events(path: str, *, strict: bool = True) -> list[dict]:
    """Parse + integrity-check an obs JSONL file.

    Every line's CRC is verified and the header's schema tag is required;
    with ``strict`` the ``obs_end`` footer must be present and agree with
    the record count (a crashed run leaves no footer — pass
    ``strict=False`` to inspect its partial log).  Raises
    :class:`repro_torch.ioutil.ArtifactError` on any integrity failure.
    """
    records = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ArtifactError(
                    f"{path}:{lineno}: not valid JSON ({e}) — truncated "
                    f"or corrupted obs log") from e
            crc = rec.get("crc")
            if crc != record_crc(rec):
                raise ArtifactError(
                    f"{path}:{lineno}: CRC mismatch (stored {crc}, "
                    f"computed {record_crc(rec)}) — corrupted obs log")
            records.append(rec)
    if not records:
        raise ArtifactError(f"{path}: empty obs log")
    head = records[0]
    if head.get("event") != "obs_start" or head.get("schema") != OBS_SCHEMA:
        raise ArtifactError(
            f"{path}: missing/unknown obs header (expected schema "
            f"{OBS_SCHEMA!r}, got {head.get('schema')!r})")
    if strict:
        tail = records[-1]
        if tail.get("event") != "obs_end":
            raise ArtifactError(
                f"{path}: no obs_end footer — the run did not close its "
                f"telemetry (crashed?); re-read with strict=False to "
                f"inspect the partial log")
        if tail.get("n_records") != len(records):
            raise ArtifactError(
                f"{path}: footer records {tail.get('n_records')} != "
                f"{len(records)} lines read — log truncated or spliced")
    return records
