"""Accuracy-parity autotuner launcher of the port: trained checkpoint ->
tuned plan (counterpart of the reference's ``launch/tune.py`` on one
device).

  PYTHONPATH=src python -m repro_torch.launch.tune --arch qwen3-0.6b \\
      [--full] [--ckpt-dir D] [--train-steps N] [--calib-steps N] \\
      [--eval-steps N] [--batch B] [--seq T] [--budget 0.01] \\
      [--grid default|quick] [--backend gather|cuda] \\
      [--plan-exec stacked|unrolled] [--out tuned_plan.npz] \\
      [--bench-out tune.json] [--no-strict] [--device cuda|cpu]

The reference's flags and defaults.  It sweeps the don't-care knobs
(``min_count`` / ``coverage`` / ``smoothing``) and the table widths
(``w_in`` / ``w_out``) against *served* quality on held-out token
streams, takes the compression-versus-quality Pareto frontier, picks the
cheapest plan within the accuracy budget (default 0.01 top-1 agreement
drop, the paper's bound), refines it per site kind, and freezes the
result into an artifact that ``launch/serve --tuned-plan`` serves with
no recapture and no recompression.

With ``--ckpt-dir`` naming a ``launch/train`` checkpoint directory the
latest checkpoint is restored; otherwise (or when the directory is empty)
a short in-process training run stands in, checkpointed there when one
is named.  On the card the tuned plans are held gather == cuda before
they are frozen, and the saved artifact, loaded back, must decode
token-for-token what the live plans decode on both backends; on the CPU
(``--device cpu``) the cuda backend cannot run, so the round trip runs on
gather alone and the log says so.

Exits with status 1 unless the selected plan meets the budget, is
strictly cheaper than the untuned default plan and the frontier has at
least three points (``--no-strict`` downgrades the three to warnings).
It runs on the card unless ``--device cpu``; with no card it exits with
status 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.calib import capture_model, model_batch, synthetic_batches
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import launch_counts
from repro_torch.obs.log import as_logger
from repro_torch.serve import verify_backend_equivalence
from repro_torch.tune import (
    autotune,
    default_grid,
    greedy_tokens,
    heldout_batches,
    load_tuned_plan,
    save_tuned_plan,
    trained_params,
    tuned_plan_from_outcome,
)

# greedy tokens a request the round trip decodes
ROUND_TRIP_TOKENS = 4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.tune")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke "
                         "config)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="launch/train checkpoint directory: restored when "
                         "non-empty, else the fallback training run "
                         "checkpoints here")
    ap.add_argument("--train-steps", type=int, default=60,
                    help="in-process fallback training steps")
    ap.add_argument("--train-batch", type=int, default=8)
    ap.add_argument("--train-seq", type=int, default=32)
    ap.add_argument("--calib-steps", type=int, default=4,
                    help="capture batches for the shared sweep capture")
    ap.add_argument("--eval-steps", type=int, default=4,
                    help="held-out parity evaluation batches")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--budget", type=float, default=0.01,
                    help="max measured top-1 agreement drop (paper bound)")
    ap.add_argument("--grid", choices=("default", "quick"),
                    default="default")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--backend", choices=("gather", "cuda"),
                    default="gather",
                    help="the backend the sweep serves its tables on: "
                         "gather (the plain form) or cuda (the kernels, "
                         "on the card)")
    ap.add_argument("--plan-exec", choices=("stacked", "unrolled"),
                    default="stacked")
    ap.add_argument("--out", default="tuned_plan.npz",
                    help="tuned-plan artifact path")
    ap.add_argument("--bench-out", default=None,
                    help="write the tune_bench/v1 JSON here")
    ap.add_argument("--no-strict", action="store_true",
                    help="warn instead of failing when the budget is "
                         "missed, the tuned plan is not cheaper or the "
                         "frontier is degenerate")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def setup(args) -> dict:
    """The device and the config (the smoke config unless ``--full``);
    raises without a card unless ``--device cpu``, and for the cuda
    backend off the card."""
    dev = resolve_device(args.device)
    if args.backend == "cuda" and dev.type != "cuda":
        raise ValueError(f"--backend cuda runs the CUDA kernels and needs "
                         f"--device cuda, got --device {args.device}")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    return {"cfg": cfg, "device": dev}


def bench_payload(args, cfg, info, outcome, wall_s: float) -> dict:
    """The ``tune_bench/v1`` row, as the reference's launcher writes it
    (the sweep rows also carry each point's evaluation seconds)."""
    return {
        "schema": "tune_bench/v1",
        "arch": args.arch,
        "family": cfg.family,
        "scale": "full" if args.full else "smoke",
        "budget": args.budget,
        "budget_met": outcome.budget_met,
        "trained": info,
        "calib_steps": args.calib_steps,
        "eval_steps": args.eval_steps,
        "eval_tokens": outcome.metrics.n_tokens,
        "grid": args.grid,
        "frontier": [r.to_dict() for r in outcome.frontier],
        "sweep": [r.to_dict() for r in outcome.results],
        "default": outcome.default.to_dict(),
        "selected": (outcome.selected.to_dict()
                     if outcome.selected else None),
        "assignment": {k: p.label()
                       for k, p in outcome.assignment.items()},
        "tuned": {
            "cost": outcome.cost,
            "table_bytes": outcome.plans.table_bytes(),
            "metrics": outcome.metrics.to_dict(),
        },
        "greedy": {k: v for k, v in outcome.greedy.items()
                   if k != "history"},
        "greedy_history": outcome.greedy.get("history", []),
        "wall_s": round(wall_s, 2),
    }


def strict_failures(args, outcome) -> list[str]:
    """The reference launcher's three rules, each failure named with its
    numbers."""
    failures = []
    if not outcome.budget_met:
        failures.append(
            f"budget not met: measured top-1 drop "
            f"{outcome.metrics.top1_drop:.4f} > {args.budget}")
    if not outcome.improved:
        failures.append(
            f"no footprint win: tuned cost {outcome.cost} vs default "
            f"{outcome.default.cost}")
    if len(outcome.frontier) < 3:
        failures.append(
            f"degenerate frontier: {len(outcome.frontier)} non-dominated "
            f"points (expected >= 3) — widen the grid or the eval set")
    return failures


def run(args, log=print, run_setup: dict | None = None) -> dict:
    """Restore or train, capture, sweep, select, hold the backends
    equal, save the artifact and round-trip it.  Returns ``{"cfg",
    "params", "info", "outcome", "path", "payload", "failures",
    "stages"}`` (each stage's wall seconds, the device synchronized),
    ``"sweep_launches"`` (the kernels the sweep and selection launched)
    and ``"round_trip"`` (the live tokens and the backends held)."""
    log = as_logger(log)
    t_start = time.perf_counter()
    s = run_setup or setup(args)
    cfg, dev = s["cfg"], s["device"]
    stages = {}

    def stage(name, t0):
        synchronize(dev)
        stages[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, info = trained_params(
        cfg, ckpt_dir=args.ckpt_dir, train_steps=args.train_steps,
        batch=args.train_batch, seq=args.train_seq, device=dev)
    stage("restore" if info["source"] == "checkpoint" else "train", t0)
    log.info("tune_params", f"params: {info}")

    t0 = time.perf_counter()
    cap = capture_model(
        params, cfg, synthetic_batches(cfg, args.calib_steps,
                                       batch_size=args.batch,
                                       seq_len=args.seq, seed=1))
    stage("capture", t0)
    log.info("tune_capture", f"capture: {cap.summary()}")

    batches = heldout_batches(cfg, args.eval_steps, batch_size=args.batch,
                              seq_len=args.seq)
    grid = default_grid(cfg, quick=args.grid == "quick")
    before = launch_counts()
    t0 = time.perf_counter()
    outcome = autotune(cfg, params, cap, batches, grid=grid,
                       budget=args.budget, workers=args.workers,
                       backend=args.backend, plan_exec=args.plan_exec,
                       verbose=True,
                       log=lambda m: log.info("tune_sweep", m))
    stage("sweep", t0)
    after = launch_counts()
    sweep_launches = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
    log.info("tune_outcome", outcome.summary())
    log.info("tune_frontier", "frontier:")
    for r in outcome.frontier:
        log.info("frontier_point",
                 f"  {r.point.label()}: cost={r.cost} "
                 f"bytes={r.table_bytes} drop={r.metrics.top1_drop:.4f} "
                 f"kl={r.metrics.kl:.3e} "
                 f"ppl_delta={r.metrics.ppl_delta:+.4f}",
                 label=r.point.label(), cost=r.cost,
                 table_bytes=r.table_bytes,
                 top1_drop=round(r.metrics.top1_drop, 6))
    sel = outcome.selected
    log.info("tune_selected",
             f"selected: {sel.point.label() if sel else None}; assignment "
             f"{ {k: p.label() for k, p in outcome.assignment.items()} }; "
             f"greedy {outcome.greedy.get('evals', 0)} evaluations: "
             f"{outcome.greedy.get('history', [])}")
    log.info("tune_cost", f"tuned cost {outcome.cost} P-LUTs against the "
             f"default's {outcome.default.cost}; sweep launches "
             f"{sweep_launches}", cost=outcome.cost,
             default_cost=outcome.default.cost)

    rng = np.random.default_rng(0)
    batch = model_batch(cfg, rng, args.batch, min(args.seq, 8))
    backends = ("gather", "cuda") if dev.type == "cuda" else ("gather",)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        # gather and cuda must give the same tokens on the final plans
        # before they are frozen
        verify_backend_equivalence(cfg, params, outcome.plans, batch, 3)
        log.info("backend_equivalence",
                 "backend equivalence: gather == cuda on the tuned plans")
    else:
        log.info("backend_equivalence", "backend equivalence: the cuda "
                 "backend needs the card; not held on the CPU")
    stage("backend_equivalence", t0)

    tp = tuned_plan_from_outcome(cfg, outcome, extra_meta={
        "trained": info, "arch_cli": args.arch})
    path = save_tuned_plan(args.out, tp)
    log.info("plan_saved", f"saved tuned plan -> {path}", path=path)

    # round-trip identity: the loaded artifact must decode token-for-token
    # what the in-process plans decode
    t0 = time.perf_counter()
    loaded = load_tuned_plan(path)
    loaded.patched_config(cfg)   # arch/depth binding check
    live = greedy_tokens(
        cfg, params, batch, ROUND_TRIP_TOKENS,
        lut_tables=outcome.plans.tables_for_model(backend="gather",
                                                  device=dev))
    stage("greedy", t0)
    t0 = time.perf_counter()
    for backend in backends:
        got = greedy_tokens(
            cfg, params, batch, ROUND_TRIP_TOKENS,
            lut_tables=loaded.tables_for_model(backend=backend, device=dev))
        assert got == live, (
            f"tuned-plan round trip diverged [{backend}]: {got} vs {live}")
    stage("round_trip", t0)
    log.info("round_trip", f"artifact round trip: token-identical on "
             f"{' and '.join(backends)} ({ROUND_TRIP_TOKENS} tokens x "
             f"{args.batch} requests)")

    payload = bench_payload(args, cfg, info, outcome,
                            time.perf_counter() - t_start)
    if args.bench_out:
        with open(args.bench_out, "w") as f:
            json.dump(payload, f, indent=1)
        log.info("bench_written", f"wrote {args.bench_out}",
                 path=args.bench_out)
    failures = strict_failures(args, outcome)
    for msg in failures:
        if args.no_strict:
            log.warn("tune_warning", f"WARNING: {msg}")
        else:
            log.error("tune_failure", f"FAIL: {msg}")
    log.info("tune_stages", f"stages (s): "
             f"{ {k: round(v, 3) for k, v in stages.items()} }",
             **{k: round(v, 3) for k, v in stages.items()})
    return {"cfg": cfg, "params": params, "info": info, "outcome": outcome,
            "path": path, "payload": payload, "failures": failures,
            "stages": stages, "sweep_launches": sweep_launches,
            "round_trip": {"tokens": live, "backends": backends}}


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        s = setup(args)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    out = run(args, run_setup=s)
    return 1 if out["failures"] and not args.no_strict else 0


if __name__ == "__main__":
    sys.exit(main())
