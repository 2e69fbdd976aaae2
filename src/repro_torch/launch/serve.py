"""Serving launcher of the port: batched prefill + greedy decode with
ReducedLUT-compressed activations (counterpart of the reference's
``launch/serve.py`` on one device).

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-0.6b|deepseek-moe-16b|qwen3-moe-30b-a3b|rwkv6-3b \\
      --full --batch 4 --prompt-len 64 --new-tokens 16 --lut-act \\
      --calib-steps 2 [--lut-sites act|all] \\
      [--logit-softcap S] [--plan-exec stacked|unrolled] [--lut-fuse] \\
      [--lut-backend cuda|gather] [--kv-int8] [--calib-path P] \\
      [--save-plan P] [--tuned-plan P] [--device cuda|cpu]

``--lut-act`` serves engine-selected plans for every LUT site in scope:
the activation sites by default, every registered site (softmax exp,
norm rsqrt, rope sine, logit softcap) under ``--lut-sites all``;
``--calib-steps N`` streams N batches through the exact model and gives
every (layer, site) its own don't-care mask and table (by default served
as one stacked ``(L, …)`` family, ``--plan-exec stacked``).  Without it
all layers share one table built from a synthetic calibration sample.
``--calib-path`` loads a saved calibration artifact when present and
saves the captured one otherwise, so restarts skip recapture;
``--save-plan`` freezes the built plans into a tuned-plan artifact, and
``--tuned-plan`` serves one (either package's) without capture or
compression.  ``--lut-backend cuda`` runs the LUT through the
hand-written kernels, ``gather`` through the plain PyTorch form;
``--lut-fuse`` applies the LUT in the up-projection's GEMM epilogue
(kernel K3 on ``cuda``) and serves the other per-layer sites out of one
multi-site super-slab (kernel K4).  ``--kv-int8`` replays the prompt
into an int8 KV cache through the decode step (the dense and moe
families; it does nothing for the ssm family, as in the reference).

On the card the decode step is captured in a CUDA graph once, before
the decode clock starts (its seconds are logged on their own line), and
replayed per token; on the CPU it runs eagerly.  The run uses the card
unless ``--device cpu`` is given, and the backend follows the device
unless named: ``cuda`` on the card, ``gather`` on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from repro_torch.calib import (
    capture_calibration,
    load_calibration,
    model_batch,
    save_calibration,
    synthetic_batches,
)
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import launch_counts
from repro_torch.nn import init_params
from repro_torch.serve import (
    CapturedStep,
    build_serving_plans,
    decode_fn,
    decode_step,
    init_cache,
    prefill,
    prefill_replay,
    tables_nbytes,
)
from repro_torch.tune import (
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_serving,
)


# the families whose decode state is a KV cache that --kv-int8 quantizes
KV_INT8_FAMILIES = ("dense", "moe")


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
                         "backend, its plain version on gather) and, with "
                         "--plan-exec stacked, serve every per-layer site "
                         "from one multi-site super-slab (kernel K4)")
    ap.add_argument("--lut-sites", choices=("act", "all"), default="act",
                    help="LUT site scope: act (the activation sites only, "
                         "the default) or all (every registered site — "
                         "softmax exp, norm rsqrt, logit softcap, rope)")
    ap.add_argument("--logit-softcap", type=float, default=None,
                    help="tanh soft-cap the final logits at this scale "
                         "(enables the network-global softcap LUT site)")
    ap.add_argument("--calib-steps", type=int, default=0,
                    help="capture N batches for per-site don't-care masks "
                         "(0 = shared synthetic calibration)")
    ap.add_argument("--calib-path", default=None,
                    help="calibration artifact (.npz): loaded if present, "
                         "else saved after capture")
    ap.add_argument("--tuned-plan", default=None,
                    help="tuned-plan artifact (.npz, of either package): "
                         "serve its plans directly, skipping capture and "
                         "compression")
    ap.add_argument("--save-plan", default=None, metavar="PATH",
                    help="freeze the built serving plans into a tuned-plan "
                         "artifact at PATH")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (dense and moe families): the "
                         "prompt is replayed into it through the decode "
                         "step, which writes quantized entries")
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
    if (args.lut_sites != "act" or args.logit_softcap is not None
            or args.lut_fuse):
        cfg = dataclasses.replace(cfg, lut_sites=args.lut_sites,
                                  logit_softcap=args.logit_softcap,
                                  lut_fuse=args.lut_fuse)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    tokens = model_batch(cfg, rng, args.batch, args.prompt_len)["tokens"]
    batch = {"tokens": torch.as_tensor(tokens, device=dev).long()}
    return cfg, params, batch, rng


def param_summary(params) -> str:
    """The parameters' count and bytes and, on the card, the peak memory
    the process has allocated so far."""
    n = sum(p.numel() for p in params.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    dev = params.embed.device
    peak = (f", peak allocated {torch.cuda.max_memory_allocated(dev)} bytes"
            if dev.type == "cuda" else "")
    return f"parameters: {n} ({nbytes} bytes){peak}"


def _exists(path: str) -> bool:
    """An artifact at ``path``: the savers append ``.npz`` when it is
    missing, so both spellings find it."""
    return os.path.exists(path) or os.path.exists(path + ".npz")


def calibration(args, cfg, params, log=print):
    """The per-site calibration set: loaded from ``--calib-path`` when an
    artifact is there, else captured over ``max(1, --calib-steps)``
    batches (and saved to ``--calib-path`` when one is named)."""
    if args.calib_path and _exists(args.calib_path):
        calib = load_calibration(args.calib_path)
        log(f"loaded calibration: {calib.summary()}")
        return calib
    steps = max(1, args.calib_steps)
    batches = synthetic_batches(cfg, steps, batch_size=args.batch,
                                seq_len=args.prompt_len, seed=1)
    t0 = time.perf_counter()
    calib = capture_calibration(params, cfg, batches,
                                min_count=args.calib_min_count,
                                smoothing=args.calib_smoothing)
    log(f"captured {steps} calibration batches in "
        f"{time.perf_counter() - t0:.2f}s ({len(calib.masks)} sites)")
    if args.calib_path:
        log(f"saved calibration -> "
            f"{save_calibration(args.calib_path, calib)}")
    return calib


def build_plans(args, cfg, params, rng, log=print):
    """Capture (``--calib-steps``) or load (``--calib-path``) the
    calibration and compress the serving plans."""
    if args.calib_steps > 0 or args.calib_path:
        calib = calibration(args, cfg, params, log=log)
    else:
        calib = rng.normal(size=100000) * 3
    t0 = time.perf_counter()
    plans = build_serving_plans(cfg, calib, backend=args.lut_backend,
                                plan_exec=args.plan_exec)
    log(f"plans built in {time.perf_counter() - t0:.2f}s: "
        f"{plans.summary()}")
    return plans


def load_plan(ap, args, log=print):
    """The ``--tuned-plan`` artifact, or a parser error naming what is
    wrong with it (the reference's messages)."""
    if not _exists(args.tuned_plan):
        ap.error(f"--tuned-plan: no artifact at {args.tuned_plan!r} — "
                 f"run launch/tune (or launch/serve --save-plan) to "
                 f"produce one")
    try:
        tp = load_tuned_plan(args.tuned_plan)
    except ValueError as e:   # includes ArtifactError (corrupt file)
        ap.error(f"--tuned-plan: {e}")
    log(f"{tp.summary()} (loaded from {args.tuned_plan} — no "
        f"recapture/recompression)")
    return tp


def serving_tables(args, plans, device, log=print) -> dict:
    """The ``lut_tables`` of ``plans`` (built :class:`ServingPlans` or a
    loaded :class:`~repro_torch.tune.TunedPlan`) in the flags' form."""
    kernel = ("fused" if args.lut_fuse and args.plan_exec == "stacked"
              else None)
    tables = plans.tables_for_model(backend=args.lut_backend,
                                    plan_exec=args.plan_exec, kernel=kernel,
                                    device=device)
    log(f"tables: backend={args.lut_backend} plan_exec={args.plan_exec} "
        f"kernel={tables['kernel']} ({tables_nbytes(tables)} table bytes)")
    return tables


def serve(args, cfg, params, batch, lut_tables, log=print, *,
          eager: bool = False) -> dict:
    """Prefill the prompts (``--kv-int8``: then replay them into an int8
    cache) and decode ``--new-tokens`` greedy tokens.  On the card the
    step is captured in a CUDA graph before the decode clock starts;
    ``eager=True`` decodes through the eager step instead (the yardstick
    the captured step is held against).  Returns the tokens (B, n_new),
    the prefill, capture and replay seconds and decode tok/s (host clock
    around synchronised work)."""
    dev = batch["tokens"].device
    b, t = batch["tokens"].shape
    max_seq = t + args.new_tokens
    synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, batch, max_seq=max_seq,
                            lut_tables=lut_tables)
    synchronize(dev)
    prefill_s = time.perf_counter() - t0
    log(f"prefill {b}x{t}: {prefill_s:.4f}s")
    if eager:
        step = lambda c, tk, pos: decode_step(params, cfg, c, tk, pos,
                                              lut_tables)
    else:
        step = decode_fn(params, cfg, lut_tables)
    out = {"prefill_s": prefill_s, "capture_s": None, "replay_s": None}
    int8 = args.kv_int8 and cfg.family in KV_INT8_FAMILIES
    if int8:
        # the decode write path quantizes: replay the prompt into an int8
        # cache through the step the decode then runs
        cache = init_cache(cfg, b, max_seq, device=dev, kv_dtype="int8")
        log("int8 KV cache enabled (decode writes quantized entries)")
    if isinstance(step, CapturedStep):
        step.capture(cache, batch["tokens"][:, :1])
        out["capture_s"] = step.capture_s
        log(f"decode step captured in a CUDA graph: {step.capture_s:.4f}s")
    if int8:
        t0 = time.perf_counter()
        logits, cache = prefill_replay(params, cfg, cache, batch["tokens"],
                                       0, lut_tables, step=step)
        synchronize(dev)
        out["replay_s"] = time.perf_counter() - t0
        log(f"prefill replay {b}x{t} into the int8 cache: "
            f"{out['replay_s']:.4f}s")
    tok = logits[:, -1].argmax(-1)[:, None]
    toks = []
    synchronize(dev)
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        toks.append(tok)
        logits, cache = step(cache, tok, t + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(toks, dim=1).tolist() if toks else [[]] * b
    tok_s = args.new_tokens * b / dt if dt > 0 else float("inf")
    log(f"decode {args.new_tokens} tokens x {b} requests: {dt:.4f}s "
        f"({tok_s:.1f} tok/s)")
    log(f"request 0: {tokens[0]}")
    return dict(out, tokens=tokens, decode_s=dt, decode_tok_s=tok_s)


def main(argv=None) -> dict:
    ap = build_parser()
    args = parse_args(argv, ap)
    try:
        cfg, params, batch, rng = setup(args)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    print(f"{cfg.name}: {param_summary(params)}")
    lut_tables = plans = None
    if args.tuned_plan:
        plans = load_plan(ap, args)
    elif args.lut_act:
        plans = build_plans(args, cfg, params, rng)
    if args.save_plan:
        if plans is None or args.tuned_plan:
            ap.error("--save-plan needs --lut-act plans built in-process "
                     "(a --tuned-plan artifact already is one)")
        frozen = save_tuned_plan(args.save_plan,
                                 tuned_plan_from_serving(cfg, plans))
        print(f"saved tuned plan -> {frozen} (reload-ready)")
    if plans is not None:
        cfg = plans.patched_config(cfg)
        lut_tables = serving_tables(args, plans, params.embed.device)
    out = serve(args, cfg, params, batch, lut_tables)
    print(f"kernel launches: {launch_counts()}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
