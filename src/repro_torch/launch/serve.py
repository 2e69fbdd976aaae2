"""Serving launcher of the port: batched prefill + greedy decode with
ReducedLUT-compressed MLP activations (counterpart of the reference's
``launch/serve.py`` on one device).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --full --batch 4 --prompt-len 64 --new-tokens 16 --lut-act \\
      --calib-steps 2 [--plan-exec stacked|unrolled] [--lut-fuse] \\
      [--lut-backend cuda|gather] [--device cuda|cpu]

``--lut-act`` serves engine-selected plans for every activation site;
``--calib-steps N`` streams N batches through the exact model and gives
every (layer, site) its own don't-care mask and table (by default served
as one stacked ``(L, …)`` family, ``--plan-exec stacked``).  Without it
all layers share one table built from a synthetic calibration sample.
``--lut-backend cuda`` runs the LUT through the hand-written kernels,
``gather`` through the plain PyTorch form; ``--lut-fuse`` applies the LUT
in the up-projection's GEMM epilogue (kernel K3 on ``cuda``).  The run
uses the card unless ``--device cpu`` is given, and the backend follows
the device unless named: ``cuda`` on the card, ``gather`` on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.calib import (
    capture_calibration,
    model_batch,
    synthetic_batches,
)
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.nn import init_params
from repro_torch.serve import (
    build_serving_plans,
    decode_step,
    prefill,
    tables_nbytes,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published widths (default: the smoke "
                         "config, 2 layers of width 64)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--lut-act", action="store_true")
    ap.add_argument("--lut-backend", choices=("gather", "cuda"),
                    default=None,
                    help="cuda (the kernels; default on the card) or gather "
                         "(the plain form; default with --device cpu)")
    ap.add_argument("--plan-exec", choices=("stacked", "unrolled"),
                    default="stacked",
                    help="per-layer tables as one stacked (L, ...) family "
                         "(default) or one entry per layer")
    ap.add_argument("--lut-fuse", action="store_true",
                    help="apply the LUT activation in the MLP up-"
                         "projection's GEMM epilogue (kernel K3 on the cuda "
                         "backend, its plain version on gather)")
    ap.add_argument("--calib-steps", type=int, default=0,
                    help="capture N batches for per-site don't-care masks "
                         "(0 = shared synthetic calibration)")
    ap.add_argument("--calib-min-count", type=int, default=1,
                    help="min observations for a bin to stay care")
    ap.add_argument("--calib-smoothing", type=int, default=0,
                    help="neighbour-smoothing radius (bins)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def parse_args(argv=None, ap: argparse.ArgumentParser | None = None):
    """Parse the launcher's flags; an unnamed ``--lut-backend`` follows
    ``--device``: ``cuda`` (the kernels) on the card, ``gather`` on the
    CPU."""
    ap = ap or build_parser()
    args = ap.parse_args(argv)
    if args.lut_backend is None:
        try:
            on_card = torch.device(args.device).type == "cuda"
        except RuntimeError as e:
            ap.error(str(e))
        args.lut_backend = "cuda" if on_card else "gather"
    return args


def setup(args):
    """``(cfg, params, batch, rng)``: config, random parameters (seed 0)
    and the prompt batch on the serving device."""
    dev = resolve_device(args.device)
    if args.lut_backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"--lut-backend cuda runs the CUDA kernels and needs "
            f"--device cuda, got --device {args.device}")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    if args.lut_fuse:
        cfg = dataclasses.replace(cfg, lut_fuse=True)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    tokens = model_batch(cfg, rng, args.batch, args.prompt_len)["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=dev).long()}
    return cfg, params, batch, rng


def build_plans(args, cfg, params, rng, log=print):
    """Capture (``--calib-steps``) and compress the serving plans."""
    if args.calib_steps > 0:
        batches = synthetic_batches(cfg, args.calib_steps,
                                    batch_size=args.batch,
                                    seq_len=args.prompt_len, seed=1)
        t0 = time.perf_counter()
        calib = capture_calibration(params, cfg, batches,
                                    min_count=args.calib_min_count,
                                    smoothing=args.calib_smoothing)
        log(f"captured {args.calib_steps} calibration batches in "
            f"{time.perf_counter() - t0:.2f}s ({len(calib.masks)} sites)")
    else:
        calib = rng.normal(size=100000) * 3
    t0 = time.perf_counter()
    plans = build_serving_plans(cfg, calib, backend=args.lut_backend,
                                plan_exec=args.plan_exec)
    log(f"plans built in {time.perf_counter() - t0:.2f}s: "
        f"{plans.summary()}")
    return plans


def serving_tables(args, plans, device, log=print) -> dict:
    kernel = ("fused" if args.lut_fuse and args.lut_backend == "cuda"
              and args.plan_exec == "stacked" else None)
    tables = plans.tables_for_model(backend=args.lut_backend,
                                    plan_exec=args.plan_exec, kernel=kernel,
                                    device=device)
    log(f"tables: backend={args.lut_backend} plan_exec={args.plan_exec} "
        f"kernel={tables['kernel']} ({tables_nbytes(tables)} table bytes)")
    return tables


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(args, cfg, params, batch, lut_tables, log=print) -> dict:
    """Prefill the prompts and decode ``--new-tokens`` greedy tokens.
    Returns the tokens (B, n_new), the prefill seconds and decode tok/s
    (host clock around synchronised work)."""
    dev = batch["tokens"].device
    b, t = batch["tokens"].shape
    max_seq = t + args.new_tokens
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch, max_seq=max_seq,
                            lut_tables=lut_tables)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"prefill {b}x{t}: {prefill_s:.4f}s")
    tok = logits[:, -1].argmax(-1)[:, None]
    toks = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        toks.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok, t + i,
                                    lut_tables=lut_tables)
        tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(toks, dim=1).tolist() if toks else [[]] * b
    tok_s = args.new_tokens * b / dt if dt > 0 else float("inf")
    log(f"decode {args.new_tokens} tokens x {b} requests: {dt:.4f}s "
        f"({tok_s:.1f} tok/s)")
    log(f"request 0: {tokens[0]}")
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": dt,
            "decode_tok_s": tok_s}


def main(argv=None) -> dict:
    ap = build_parser()
    args = parse_args(argv, ap)
    try:
        cfg, params, batch, rng = setup(args)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    lut_tables = None
    if args.lut_act:
        plans = build_plans(args, cfg, params, rng)
        cfg = plans.patched_config(cfg)
        lut_tables = serving_tables(args, plans, params.embed.device)
    out = serve(args, cfg, params, batch, lut_tables)
    print(f"kernel launches: {launch_counts()}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
