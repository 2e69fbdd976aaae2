"""Render the dry run's tables (the reference's ``roofline/report.py``) from
the JSONs of :mod:`repro_torch.launch.dryrun`, against an H100's peaks
(:mod:`.analysis`).  The rendering is the reference's, line for line, so
either package's report reads either package's JSONs.  The numbers are
model numbers from the peaks, not measurements.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report \
           [--dir experiments/torch/dryrun]
Prints markdown to stdout.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .analysis import PEAK_FLOPS


def load(dir_: str):
    cells = {}
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        cells[(c["arch"], c["shape"], c["mesh"])] = c
    return cells


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def bottleneck_note(cell) -> str:
    rf = cell["roofline"]
    dom = rf["dominant"]
    if dom == "memory":
        return ("fewer f32 elementwise passes / larger per-device "
                "microbatch raises arithmetic intensity")
    if dom == "collective":
        return "overlap or shrink grad/param collectives (compression, fsdp tuning)"
    return "already MXU-bound; fuse smaller ops"


def dryrun_table(cells, mesh: str) -> str:
    rows = [
        "| arch | shape | status | compile_s | HLO flops/dev | HBM bytes/dev "
        "| coll bytes/dev | argument GiB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), c in sorted(cells.items()):
        if m != mesh:
            continue
        if c["status"] != "ok":
            reason = c.get("reason", c.get("error", ""))[:60]
            rows.append(f"| {arch} | {shape} | {c['status']}: {reason} | | | | | |")
            continue
        rf = c["roofline"]
        arg = c["memory"].get("argument_size_in_bytes", 0) / 2**30
        rows.append(
            f"| {arch} | {shape} | ok | {c['compile_s']} | "
            f"{rf['flops']:.2e} | {rf['hbm_bytes']:.2e} | "
            f"{rf['coll_bytes']:.2e} | {arg:.2f} |"
        )
    return "\n".join(rows)


def roofline_table(cells) -> str:
    rows = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS/HLO | roofline-frac | what moves the bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m), c in sorted(cells.items()):
        if m != "16x16":
            continue
        if c["status"] != "ok":
            rows.append(
                f"| {arch} | {shape} | — | — | — | {c['status']} | — | — | "
                f"{c.get('reason', c.get('error', ''))[:70]} |")
            continue
        rf = c["roofline"]
        mf = c["model_flops"] / c["n_chips"]
        ratio = mf / rf["flops"] if rf["flops"] else 0.0
        bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
        frac = (mf / PEAK_FLOPS) / bound if bound else 0.0
        rows.append(
            f"| {arch} | {shape} | {_fmt_s(rf['compute_s'])} | "
            f"{_fmt_s(rf['memory_s'])} | {_fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {ratio:.2f} | {frac:.4f} | "
            f"{bottleneck_note(c)} |"
        )
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/torch/dryrun")
    args = ap.parse_args(argv)
    cells = load(args.dir)
    n_ok = sum(1 for c in cells.values() if c["status"] == "ok")
    n_skip = sum(1 for c in cells.values() if c["status"] == "skipped")
    print(f"## Dry-run ({n_ok} ok / {n_skip} skipped / {len(cells)} cells)\n")
    for mesh in ("16x16", "2x16x16"):
        print(f"### mesh {mesh}\n")
        print(dryrun_table(cells, mesh))
        print()
    print("## Roofline (single-pod 16x16; per-device terms)\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
