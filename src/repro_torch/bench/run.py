"""Benchmark entry point: one section per paper table / figure, run on
the device.

  PYTHONPATH=src python -m repro_torch.bench.run [--scale small|paper] \\
      [--workers N] [--device cuda|cpu] [--out DIR]

Counterpart of the reference's ``benchmarks/run.py``: Table 2, Fig. 3 and
the beyond-paper variants, in its order, then the
``name,us_per_call,derived`` CSV rows.  Training, don't-care marking and
accuracy run on the card unless ``--device cpu`` is given (K7; tables
rebuilt through K5 / K6); compression runs on the host, over ``--workers``
engine processes.  ``--scale`` and ``--workers`` default to
``REPRO_BENCH_SCALE`` (else ``small``) and ``REPRO_BENCH_WORKERS`` (else
2); results go to ``--out`` (default ``experiments/torch/``).
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.engine import shutdown_pools
from repro_torch.device import resolve_device

from . import beyond, fig3, table2
from .common import SCALED_MODELS, bench_scale, bench_workers


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("--scale", choices=sorted(SCALED_MODELS),
                    default=bench_scale(),
                    help="model and data scale (default: "
                         "REPRO_BENCH_SCALE, else small)")
    ap.add_argument("--workers", type=int, default=bench_workers(),
                    help="engine worker processes (default: "
                         "REPRO_BENCH_WORKERS, else 2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="directory of the JSON results (default: "
                         "experiments/torch/)")
    return ap


def main(argv=None) -> list[tuple[str, float, str]]:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    kw = dict(scale=args.scale, device=dev, out_dir=args.out)

    print(f"# ReducedLUT benchmarks (scale={args.scale}, device={dev})")
    rows: list[tuple[str, float, str]] = []
    try:
        print("## Table 2: P-LUT utilization / accuracy (paper SS5.2)")
        t0 = time.time()
        t2, timing = table2.run(workers=args.workers, **kw)
        for r in t2:
            name = f"table2_{r['model']}_{r['method']}" + (
                f"_ex{r['exiguity']}" if r["exiguity"] else "")
            derived = (f"pluts={r['pluts']};test_acc={r['test_acc']:.4f};"
                       f"train_acc={r['train_acc']:.4f}")
            if "vs_baseline" in r:
                derived += f";vs_baseline={r['vs_baseline']}"
            if "vs_compressedlut" in r:
                derived += f";vs_compressedlut={r['vs_compressedlut']}"
            rows.append((name, r["seconds"] * 1e6, derived))
        for t in timing:
            rows.append((
                f"table2_engine_{t['model']}_w{t['workers']}",
                t["engine_s"] * 1e6,
                f"serial_s={t['serial_s']};speedup={t['speedup']};"
                f"identical={t['identical']}",
            ))
        print(f"  [table2 {time.time() - t0:.0f}s]")

        print("## Fig 3: exiguity sweep")
        for r in fig3.run("jsc-2l", workers=args.workers, **kw):
            rows.append((
                f"fig3_jsc-2l_ex{r['exiguity']}", r["seconds"] * 1e6,
                f"pluts={r['pluts']};test_acc={r['test_acc']:.4f}",
            ))

        print("## Beyond-paper variants (bias_care_only / multi-sweep)")
        for r in beyond.run("jsc-2l", **kw):
            rows.append((f"beyond_{r['model']}_{r['variant']}",
                         r["seconds"] * 1e6, f"pluts={r['pluts']}"))
    finally:
        shutdown_pools()

    print("## Kernel micro-benchmarks and roofline: not in this package yet "
          "(ROADMAP queue A, items 3 and 12)")

    print("\nname,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
