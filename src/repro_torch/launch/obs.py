"""Obs report CLI: render a ``repro-obs/v1`` JSONL log for humans (port
of the reference's ``launch/obs.py``: the same report from the same log,
of either package).

Reads the structured telemetry file ``launch/serve --obs-log`` writes,
integrity-checks every line (CRC + header + footer, see
:func:`repro_torch.obs.read_events`), and prints

* the run header (schema, wall-clock start, record count),
* the event timeline, span-indented, one line per record,
* the per-site don't-care drift table (served fraction vs the
  calibration-time baseline and their difference — the retune signal),
* the metrics footer (counters/gauges totals, histogram quantiles).

  PYTHONPATH=src python -m repro_torch.launch.obs serve.obs.jsonl \
      [--no-strict] [--limit N] [--events a,b,...]

``--no-strict`` tolerates a missing/inconsistent ``obs_end`` footer (a
crashed run's partial log); corruption of any individual line is always
fatal (exit 1).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.ioutil import ArtifactError
from repro_torch.obs import read_events

# record bookkeeping fields not worth echoing per timeline line
_SKIP_FIELDS = ("seq", "t", "event", "crc", "span", "span_id", "parent",
                "name", "level", "msg")


def _fmt_fields(rec: dict) -> str:
    parts = []
    for k, v in rec.items():
        if k in _SKIP_FIELDS:
            continue
        if isinstance(v, float):
            v = f"{v:.6g}"
        elif isinstance(v, (dict, list)):
            v = repr(v)
        parts.append(f"{k}={v}")
    return " ".join(parts)


def _timeline_line(rec: dict, depth: int) -> str:
    pad = "  " * depth
    t = rec.get("t", 0.0)
    event = rec.get("event", "?")
    if event == "span_begin":
        body = f"> {rec.get('name')}"
    elif event == "span_end":
        body = f"< {rec.get('name')} ({rec.get('dur_s', 0):.4f}s)"
    else:
        body = event
        if rec.get("msg"):
            body += f": {rec['msg']}"
    rest = _fmt_fields(rec)
    line = f"{t:10.4f}  {pad}{body}"
    return f"{line}  [{rest}]" if rest else line


def render_timeline(records: list[dict], *, limit: int = 0,
                    events: set[str] | None = None) -> list[str]:
    """Span-indented timeline lines for the body records (header,
    footer and drift rows are rendered by their own sections)."""
    lines = []
    depth = 0
    for rec in records:
        event = rec.get("event")
        if event in ("obs_start", "obs_end", "drift"):
            continue
        if event == "span_end":
            depth = max(0, depth - 1)
        if events is None or event in events or event in ("span_begin",
                                                          "span_end"):
            lines.append(_timeline_line(rec, depth))
        if event == "span_begin":
            depth += 1
    if limit and len(lines) > limit:
        dropped = len(lines) - limit
        lines = lines[:limit]
        lines.append(f"... ({dropped} more lines; raise --limit)")
    return lines


def render_drift(records: list[dict]) -> list[str]:
    """The per-site drift table from ``drift`` events."""
    rows = [r for r in records if r.get("event") == "drift"]
    if not rows:
        return []
    lines = [f"{'site':<24} {'lookups':>10} {'dc_hits':>10} "
             f"{'served%':>9} {'calib%':>9} {'excess':>9}"]
    for r in sorted(rows, key=lambda r: str(r.get("site"))):
        base = r.get("calib_dontcare_frac")
        lines.append(
            f"{str(r.get('site')):<24} {r.get('lookups', 0):>10} "
            f"{r.get('dontcare_hits', 0):>10} "
            f"{100 * r.get('served_dontcare_frac', 0.0):>8.4f}% "
            f"{'   n/a   ' if base is None else f'{100 * base:>8.4f}%'} "
            f"{r.get('excess', 0.0):>+9.6f}")
    return lines


def render_metrics(footer: dict) -> list[str]:
    """Digest of the ``obs_end`` footer's metrics snapshot."""
    metrics = footer.get("metrics") or {}
    lines = []
    for name, series in sorted(metrics.items()):
        for labels, val in sorted(series.items()):
            tag = f"{name}{labels}"
            if isinstance(val, dict):    # histogram series
                p50, p95 = val.get("p50"), val.get("p95")
                lines.append(
                    f"  {tag}: n={val.get('count')} "
                    f"sum={val.get('sum')} p50<={p50} p95<={p95}")
            else:
                lines.append(f"  {tag} = {val}")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.obs")
    ap.add_argument("path", help="repro-obs/v1 JSONL file "
                                 "(launch/serve --obs-log output)")
    ap.add_argument("--no-strict", action="store_true",
                    help="tolerate a missing obs_end footer (a crashed "
                         "run's partial log)")
    ap.add_argument("--limit", type=int, default=200,
                    help="max timeline lines (0 = all)")
    ap.add_argument("--events", default=None,
                    help="comma-separated event-name filter for the "
                         "timeline (spans always shown)")
    args = ap.parse_args(argv)

    try:
        records = read_events(args.path, strict=not args.no_strict)
    except (ArtifactError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    head = records[0]
    footer = records[-1] if records[-1].get("event") == "obs_end" else {}
    print(f"obs log {args.path}: schema {head.get('schema')}, "
          f"{len(records)} records"
          + ("" if footer else " (no footer — partial log)"))

    events = (set(args.events.split(",")) if args.events else None)
    print("\n== timeline ==")
    for line in render_timeline(records, limit=args.limit, events=events):
        print(line)

    drift = render_drift(records)
    if drift:
        print("\n== don't-care drift (served vs calibration) ==")
        for line in drift:
            print(line)

    metrics = render_metrics(footer)
    if metrics:
        print("\n== metrics ==")
        for line in metrics:
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
