"""Serving launcher of the port: batched prefill + greedy decode with
ReducedLUT-compressed activations (counterpart of the reference's
``launch/serve.py``), on one device or a mesh of ranks (``--mesh``).

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch phi4-mini-3.8b|nemotron-4-15b|deepseek-67b|qwen3-0.6b|\\
             deepseek-moe-16b|qwen3-moe-30b-a3b|phi-3-vision-4.2b|\\
             rwkv6-3b|recurrentgemma-9b|whisper-small \\
      --full --batch 4 --prompt-len 64 --new-tokens 16 --lut-act \\
      --calib-steps 2 [--lut-sites act|all] \\
      [--logit-softcap S] [--plan-exec stacked|unrolled] [--lut-fuse] \\
      [--lut-backend cuda|gather] [--kv-int8] [--calib-path P] \\
      [--save-plan P] [--tuned-plan P] [--device cuda|cpu] \\
      [--reload-plan P [--watch] [--degrade] [--slo-ms MS] \\
       [--reload-max-drop D] [--reload-gate-tokens N]] \\
      [--obs-log PATH [--obs-sample N] [--obs-drift-every N]] \\
      [--mesh DP,TP [--mesh-mode gspmd|shard_map]]

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
families; it does not apply to the ssm, hybrid and encdec families, as
in the reference (for encdec the log says so), and is refused for vlm:
the replay ingests tokens only, so the image prefix would be lost).  The
default ``--arch`` is the reference launcher's, ``phi4-mini-3.8b``.

A vlm prompt is the batch's ``n_patches`` patch embeddings and then its
tokens: the cache holds ``n_patches + T + --new-tokens`` positions and
decoding starts at position ``n_patches + T`` (the reference's
``verify_backend_equivalence`` convention; its launcher decodes from
``T`` over the patch slots).  An encdec prompt is its ``n_frames`` audio
frames, which the encoder runs over once in the prefill, and its tokens;
decoding starts at ``T``.

``--reload-plan`` serves through the continuous batcher (dense and moe)
with the serving control plane attached: a
:class:`~repro_torch.serve.reload.PlanReloader` hot-loads the artifact at
the decode midpoint (or whenever its mtime changes, ``--watch``) behind
the parity gate (``--reload-max-drop``, ``--reload-gate-tokens``), and
``--degrade`` chains the per-site backend degradation ladder
(``cuda_fused -> cuda -> gather -> float``) as the fault supervisor.
The run exits with status 2 if a request was dropped and 1 if a
scheduled reload never cut over; ``--slo-ms`` counts latency-objective
violations.

``--obs-log PATH`` writes the run's telemetry (:mod:`repro_torch.obs`):
the checksummed ``repro-obs/v1`` JSONL event log at PATH (every log line
below as a structured event, the ``build_plans`` / ``prefill`` /
``decode`` spans, the batcher's and the control plane's events, one
``drift`` row per site key) and a Prometheus text dump at
``PATH.prom`` on exit; ``python -m repro_torch.launch.obs PATH`` renders
it.  With calibrated plans (``--calib-steps`` / ``--calib-path``) the
don't-care drift monitor is attached, counting on the device: every
decode step of the plain path, every ``--obs-drift-every``-th batcher
tick (and every replayed prompt token) under ``--reload-plan``; the
served tokens are the same as without it.

On the card the decode step is captured in a CUDA graph once, before
the decode clock starts (its seconds are logged on their own line), and
replayed per token; on the CPU it runs eagerly.  The run uses the card
unless ``--device cpu`` is given, and the backend follows the device
unless named: ``cuda`` on the card, ``gather`` on the CPU.

``--mesh DP,TP`` serves on a ``(data, model)`` mesh of ``DP * TP`` ranks
(:mod:`repro_torch.serve.sharded`): the launcher starts them itself, or
joins the one ``torchrun``'s environment describes.  Rank ``r`` serves on
``cuda:(r % device_count)`` (ranks share a card where there are fewer
cards; the collective backend, NCCL or gloo, follows the layout and is
logged).  Rank 0 captures the calibration and compresses the plans (or
loads ``--tuned-plan``) and hands them to the ranks, whose table bytes
must agree by checksum; each rank draws only its share of the weights.
With a card a rank the ranks run NCCL, and the sharded decode step is
captured in a CUDA graph before the decode clock starts (``mesh_captured``
logs its seconds; a moe step's expert all-gathers are inside the graph);
ranks sharing a card run gloo, whose collectives cannot be captured, and
step eagerly (``mesh_eager`` says why).  The weights are gathered once
for the prefill and its decode loop (``mesh_gather`` logs the seconds),
into buffers the captured step reads.  ``--mesh-mode shard_map``
replicates every table slab; the default ``gspmd`` splits large stacked
slabs by layer over the data axis.
``--kv-int8`` is refused with ``shard_map``, and ``--lut-fuse`` and
``--reload-plan`` with ``--mesh``, in the reference's words.  The log has
one ``mesh_serving`` event and a ``table_placement`` event a site; a mesh
is never degraded to one device (no ``mesh_unavailable``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch import obs
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
from repro_torch.obs.log import Logger, as_logger, log as obs_log
from repro_torch.serve import (
    CapturedStep,
    CompositeSupervisor,
    ContinuousBatcher,
    DegradationLadder,
    PlanReloader,
    Request,
    build_serving_plans,
    decode_fn,
    decode_start,
    decode_step,
    init_cache,
    prefill,
    prefill_replay,
    tables_nbytes,
)
from repro_torch.launch.mesh import (
    in_launched_rank,
    join_from_env,
    make_host_mesh,
    rank_device,
    run_ranks,
)
from repro_torch.tune import (
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_serving,
)


# the families whose decode state is a KV cache that --kv-int8 quantizes
KV_INT8_FAMILIES = ("dense", "moe")


def kv_int8_applies(args, cfg) -> bool:
    """Whether ``--kv-int8`` replays the prompt into an int8 cache for
    ``cfg``'s family; raises for vlm, whose prompt replay would drop the
    image prefix (the replay ingests tokens only)."""
    if args.kv_int8 and cfg.family == "vlm":
        raise ValueError(
            "--kv-int8 is refused for the vlm family: the prompt replay "
            "into the int8 cache ingests tokens only and would drop the "
            f"{cfg.n_patches} patch embeddings of the image prefix")
    return args.kv_int8 and cfg.family in KV_INT8_FAMILIES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="phi4-mini-3.8b")
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
                    help="int8 KV cache (dense and moe families; refused "
                         "for vlm; does not apply to ssm, hybrid, encdec): "
                         "the prompt is replayed into it through the decode "
                         "step, which writes quantized entries")
    ap.add_argument("--calib-min-count", type=int, default=1,
                    help="min observations for a bin to stay care")
    ap.add_argument("--calib-smoothing", type=int, default=0,
                    help="neighbour-smoothing radius (bins)")
    ap.add_argument("--reload-plan", default=None, metavar="PATH",
                    help="serve through the continuous batcher and "
                         "hot-reload the tuned-plan artifact at PATH "
                         "mid-decode behind the parity gate")
    ap.add_argument("--watch", action="store_true",
                    help="with --reload-plan: poll PATH for mtime changes "
                         "every tick instead of a one-shot scheduled "
                         "reload")
    ap.add_argument("--degrade", action="store_true",
                    help="attach the per-site backend degradation ladder "
                         "(cuda_fused -> cuda -> gather -> float) as the "
                         "batcher's fault supervisor")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency objective; violations are "
                         "counted in the serving metrics")
    ap.add_argument("--reload-max-drop", type=float, default=0.01,
                    help="parity-gate budget: max top-1 agreement drop "
                         "against the active plan (the paper's 0.01)")
    ap.add_argument("--reload-gate-tokens", type=int, default=4,
                    help="greedy tokens per shadow row that must match "
                         "the active plan at the gate")
    ap.add_argument("--obs-log", default=None, metavar="PATH",
                    help="write the structured telemetry event log "
                         "(repro-obs/v1 JSONL) to PATH; a Prometheus "
                         "text dump lands at PATH.prom on exit; with "
                         "calibrated LUT serving the don't-care drift "
                         "monitor is attached (token-identical output)")
    ap.add_argument("--obs-sample", type=int, default=1, metavar="N",
                    help="keep every Nth high-frequency tick event in "
                         "the obs log (counters and gauges are never "
                         "sampled; drops are accounted on the surviving "
                         "records)")
    ap.add_argument("--obs-drift-every", type=int, default=128,
                    metavar="N",
                    help="run the drift-monitored decode step on every "
                         "Nth batcher tick only (1 = count every step); "
                         "the monitor's counting kernels run inside the "
                         "captured step, so sampling is what keeps "
                         "enabled-mode serving within the 5%% "
                         "decode-overhead budget — the drift fraction is "
                         "a ratio and stays unbiased")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve on a (data, model) mesh of DP x TP ranks, "
                         "e.g. 2,2 — data-parallel batch x bit-exact "
                         "tensor-parallel model with placed LUT tables; "
                         "the launcher starts the ranks (or joins "
                         "torchrun's), which share the cards round robin")
    ap.add_argument("--mesh-mode", choices=("gspmd", "shard_map"),
                    default="gspmd",
                    help="gspmd (default; layer-sharded table slabs, "
                         "replay prefill) or shard_map (replicated "
                         "tables)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def open_telemetry(args) -> "obs.Telemetry | None":
    """The run's telemetry for ``--obs-log`` (``None`` without it): the
    event log at the path, sampled by ``--obs-sample``, and the
    Prometheus dump beside it.  Enter it around the run: leaving it
    writes the drift rows, the footer and the dump."""
    if not args.obs_log:
        return None
    return obs.Telemetry(
        events=obs.EventLog(args.obs_log, sample=args.obs_sample),
        prom_path=args.obs_log + ".prom")


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
    and the prompt batch on the serving device (a vlm batch carries its
    patch embeddings, float32, as ``"patches"``, an encdec batch its audio
    frames, float32, as ``"frames"``)."""
    dev = resolve_device(args.device)
    if args.lut_backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"--lut-backend cuda runs the CUDA kernels and needs "
            f"--device cuda, got --device {args.device}")
    cfg = served_config(args)
    params = init_params(cfg, seed=0, device=dev)
    batch, rng = prompt_batch(args, cfg, dev)
    return cfg, params, batch, rng


def served_config(args):
    """The flags' architecture config (``--full``, ``--lut-sites``,
    ``--logit-softcap``, ``--lut-fuse``), ``--kv-int8`` checked."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_config(cfg)
    kv_int8_applies(args, cfg)
    if (args.lut_sites != "act" or args.logit_softcap is not None
            or args.lut_fuse):
        cfg = dataclasses.replace(cfg, lut_sites=args.lut_sites,
                                  logit_softcap=args.logit_softcap,
                                  lut_fuse=args.lut_fuse)
    return cfg


def prompt_batch(args, cfg, dev):
    """``(batch, rng)``: the prompt batch on ``dev`` from the seed-0
    generator, which the shared calibration then draws from."""
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in model_batch(
        cfg, rng, args.batch, args.prompt_len).items()}
    batch["tokens"] = batch["tokens"].long()
    return batch, rng


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
    log = as_logger(log)
    if args.calib_path and _exists(args.calib_path):
        calib = load_calibration(args.calib_path)
        log.info("calib_loaded", f"loaded calibration: {calib.summary()}")
        return calib
    steps = max(1, args.calib_steps)
    batches = synthetic_batches(cfg, steps, batch_size=args.batch,
                                seq_len=args.prompt_len, seed=1)
    t0 = time.perf_counter()
    calib = capture_calibration(params, cfg, batches,
                                min_count=args.calib_min_count,
                                smoothing=args.calib_smoothing)
    dt = time.perf_counter() - t0
    log.info("calib_captured",
             f"captured {steps} calibration batches in {dt:.2f}s "
             f"({len(calib.masks)} sites)", steps=steps,
             seconds=round(dt, 3))
    if args.calib_path:
        saved = save_calibration(args.calib_path, calib)
        log.info("calib_saved", f"saved calibration -> {saved}", path=saved)
    return calib


def build_plans(args, cfg, params, rng, log=print, tel=None):
    """Capture (``--calib-steps``) or load (``--calib-path``) the
    calibration and compress the serving plans; with a calibration and a
    telemetry ``tel`` (``--obs-log``), the don't-care drift monitor is
    attached to it, counting on the parameters' device and sampled every
    ``--obs-drift-every`` batcher ticks."""
    plans, calib = compress_plans(args, cfg, params, rng, log=log)
    attach_monitor(args, tel, calib, params.embed.device)
    return plans


def calibrates(args) -> bool:
    """Whether the plans come from a per-site calibration (captured or
    loaded), which the drift monitor reads."""
    return args.calib_steps > 0 or bool(args.calib_path)


def attach_monitor(args, tel, calib, device, mesh=None, split_kinds=()):
    """The don't-care drift monitor on ``tel`` for a calibration set
    (nothing without telemetry or for a shared sample); under a ``mesh``
    it sums the ranks' counters (:meth:`DontCareMonitor.bind_mesh`)."""
    if tel is None or getattr(calib, "w_in", None) is None:
        return None
    mon = obs.DontCareMonitor(calib, sample_every=args.obs_drift_every,
                              device=device)
    if mesh is not None:
        mon.bind_mesh(mesh, split_kinds)
    tel.attach_monitor(mon)
    return mon


def compress_plans(args, cfg, params, rng, log=print):
    """``(plans, calibration)``: the calibration (captured on ``params``
    or loaded; a shared sample drawn from ``rng`` without
    ``--calib-steps`` / ``--calib-path``) and the plans compressed from
    it."""
    log = as_logger(log)
    if calibrates(args):
        calib = calibration(args, cfg, params, log=log)
    else:
        calib = rng.normal(size=100000) * 3
    t0 = time.perf_counter()
    with obs.span("build_plans", backend=args.lut_backend,
                  plan_exec=args.plan_exec):
        plans = build_serving_plans(cfg, calib, backend=args.lut_backend,
                                    plan_exec=args.plan_exec)
    log.info("plans_built", f"plans built in {time.perf_counter() - t0:.2f}s"
             f": {plans.summary()}")
    return plans, calib


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
    as_logger(log).info("tuned_plan",
                        f"{tp.summary()} (loaded from {args.tuned_plan} — "
                        f"no recapture/recompression)", path=args.tuned_plan)
    return tp


def serving_tables(args, plans, device, log=print) -> dict:
    """The ``lut_tables`` of ``plans`` (built :class:`ServingPlans` or a
    loaded :class:`~repro_torch.tune.TunedPlan`) in the flags' form."""
    kernel = ("fused" if args.lut_fuse and args.plan_exec == "stacked"
              else None)
    tables = plans.tables_for_model(backend=args.lut_backend,
                                    plan_exec=args.plan_exec, kernel=kernel,
                                    device=device)
    as_logger(log).info(
        "plan_exec", f"tables: backend={args.lut_backend} "
        f"plan_exec={args.plan_exec} kernel={tables['kernel']} "
        f"({tables_nbytes(tables)} table bytes)", plan_exec=args.plan_exec,
        table_bytes=tables_nbytes(tables))
    return tables


def serve(args, cfg, params, batch, lut_tables, log=print, *,
          eager: bool = False) -> dict:
    """Prefill the prompts (``--kv-int8``: then replay them into an int8
    cache) and decode ``--new-tokens`` greedy tokens.  On the card the
    step is captured in a CUDA graph before the decode clock starts;
    ``eager=True`` decodes through the eager step instead (the yardstick
    the captured step is held against).  Returns the tokens (B, n_new),
    the prefill, capture and replay seconds, decode tok/s (host clock
    around synchronised work) and the first decoded position.  Decoding starts at
    :func:`~repro_torch.serve.decode_start` (after a vlm's patches)."""
    log = as_logger(log)
    dev = batch["tokens"].device
    b, t = batch["tokens"].shape
    start = decode_start(cfg, batch)
    max_seq = start + args.new_tokens
    synchronize(dev)
    t0 = time.perf_counter()
    with obs.span("prefill", batch=b, prompt_len=t):
        logits, cache = prefill(params, cfg, batch, max_seq=max_seq,
                                lut_tables=lut_tables)
        synchronize(dev)
    prefill_s = time.perf_counter() - t0
    log.info("prefill", f"prefill {b}x{t}"
             + (f" after {start - t} patch embeddings" if start != t else "")
             + f": {prefill_s:.4f}s", seconds=round(prefill_s, 4))
    if eager:
        step = lambda c, tk, pos: decode_step(params, cfg, c, tk, pos,
                                              lut_tables)
    else:
        step = decode_fn(params, cfg, lut_tables)
    out = {"prefill_s": prefill_s, "capture_s": None, "replay_s": None}
    int8 = kv_int8_applies(args, cfg)
    if args.kv_int8 and cfg.family == "encdec":
        log.info("kv_int8", "--kv-int8 does not apply to the encdec "
                 "family, as in the reference's launcher: the self and "
                 "cross K/V stay in the model dtype")
    if int8:
        # the decode write path quantizes: replay the prompt into an int8
        # cache through the step the decode then runs
        cache = init_cache(cfg, b, max_seq, device=dev, kv_dtype="int8")
        log.info("kv_int8",
                 "int8 KV cache enabled (decode writes quantized entries)")
    if isinstance(step, CapturedStep):
        step.capture(cache, batch["tokens"][:, :1])
        out["capture_s"] = step.capture_s
        log.info("graph_capture", f"decode step captured in a CUDA graph: "
                 f"{step.capture_s:.4f}s", seconds=round(step.capture_s, 4))
    if int8:
        t0 = time.perf_counter()
        logits, cache = prefill_replay(params, cfg, cache, batch["tokens"],
                                       0, lut_tables, step=step)
        synchronize(dev)
        out["replay_s"] = time.perf_counter() - t0
        log.info("prefill_replay", f"prefill replay {b}x{t} into the int8 "
                 f"cache: {out['replay_s']:.4f}s",
                 seconds=round(out["replay_s"], 4))
    tok = logits[:, -1].argmax(-1)[:, None]
    toks = []
    synchronize(dev)
    t0 = time.perf_counter()
    with obs.span("decode", batch=b, new_tokens=args.new_tokens):
        for i in range(args.new_tokens):
            toks.append(tok)
            logits, cache = step(cache, tok, start + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = torch.cat(toks, dim=1).tolist() if toks else [[]] * b
    tok_s = args.new_tokens * b / dt if dt > 0 else float("inf")
    log.info("decode", f"decode {args.new_tokens} tokens x {b} requests: "
             f"{dt:.4f}s ({tok_s:.1f} tok/s)", seconds=round(dt, 4),
             tok_s=round(tok_s, 2))
    log.info("request_tokens", f"request 0: {tokens[0]}", rid=0,
             tokens=tokens[0])
    return dict(out, tokens=tokens, decode_s=dt, decode_tok_s=tok_s,
                start=start)


def serve_with_reload(args, cfg, params, batch, lut_tables, plans,
                      log=print, prompts=None) -> dict:
    """Serve the prompts (the batch's rows, or ``prompts``, token lists)
    through the continuous batcher (``--batch`` slots, ``--new-tokens``
    each, replay prefill) with the control plane attached: a
    :class:`~repro_torch.serve.reload.PlanReloader` for ``--reload-plan``
    (one-shot at the decode midpoint, or ``--watch``), chained before the
    :class:`~repro_torch.serve.degrade.DegradationLadder` with
    ``--degrade``.  Returns ``{"batcher", "reloader", "ladder",
    "finished", "metrics", "seconds"}``."""
    log = as_logger(log)
    if prompts is None:
        prompts = batch["tokens"].tolist()
    kernel = ("fused" if args.lut_fuse and args.plan_exec == "stacked"
              else None)
    ladder = None
    if args.degrade:
        if plans is None:
            log.warn("ladder_skipped", "--degrade: no LUT plans in this "
                     "serving config; ladder not attached (float path "
                     "only)")
        else:
            top = ("cuda_fused" if kernel == "fused" else
                   "cuda" if args.lut_backend == "cuda" else "gather")
            ladder = DegradationLadder(plans, plan_exec=args.plan_exec,
                                       top_rung=top,
                                       device=params.embed.device)
            # the same bits as the flags' tables, composed per site
            lut_tables = ladder.tables()
            log.info("ladder_attached",
                     f"degradation ladder attached, top rung {top}",
                     top_rung=top)
    batcher = ContinuousBatcher(
        cfg, params, args.batch,
        max(len(p) for p in prompts) + args.new_tokens, eos_token=-1,
        kv_dtype="int8" if args.kv_int8 else "bfloat16",
        lut_tables=lut_tables, prefill="replay")
    reloader = PlanReloader(batcher, cfg, params, backend=args.lut_backend,
                            plan_exec=args.plan_exec, kernel=kernel,
                            max_top1_drop=args.reload_max_drop,
                            gate_tokens=args.reload_gate_tokens,
                            ladder=ladder)
    batcher.supervisor = CompositeSupervisor(reloader, ladder)
    if args.watch:
        reloader.watch(args.reload_plan)
        log.info("reload_watch", f"watching {args.reload_plan} for plan "
                 f"updates", path=args.reload_plan)
    else:
        at_tick = max(1, args.new_tokens // 2)
        reloader.schedule(args.reload_plan, at_tick)
        log.info("reload_scheduled", f"hot reload of {args.reload_plan} "
                 f"scheduled at decode tick {at_tick}",
                 path=args.reload_plan, at_tick=at_tick)
    for i, row in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=list(row),
                               max_new=args.new_tokens, slo_ms=args.slo_ms))
    synchronize(batcher.device)
    t0 = time.perf_counter()
    finished = batcher.run()
    synchronize(batcher.device)
    dt = time.perf_counter() - t0
    for rec in reloader.records:
        log.info("reload_record", rec.summary())
    if ladder is not None:
        log.info("ladder_status",
                 "ladder: " + " ".join(f"{s}={r}" for s, r
                                       in ladder.status().items())
                 + f" (demotions {ladder.demotions}, promotions "
                   f"{ladder.promotions})", **ladder.status())
    m = batcher.metrics()
    log.info("serve_summary",
             f"served {m['finished']}/{m['submitted']} requests in "
             f"{dt:.2f}s ({m['ticks']} ticks, utilization "
             f"{m['utilization']:.2f}, {m['table_swaps']} table swaps)",
             finished=m["finished"], submitted=m["submitted"],
             seconds=round(dt, 3), ticks=m["ticks"],
             utilization=round(m["utilization"], 4),
             table_swaps=m["table_swaps"])
    log.info("serve_latency",
             f"latency p50 {m['latency_p50_s']:.3f}s p95 "
             f"{m['latency_p95_s']:.3f}s; SLO violations "
             f"{m['slo_violations']}/{m['slo_tracked']}",
             latency_p50_s=m["latency_p50_s"],
             latency_p95_s=m["latency_p95_s"],
             slo_violations=m["slo_violations"],
             slo_tracked=m["slo_tracked"])
    log.info("reload_counters", f"reload counters: {reloader.counters}",
             **reloader.counters)
    req0 = next(r for r in finished if r.rid == 0)
    log.info("request_tokens", f"request 0: {req0.out}", rid=0,
             tokens=req0.out)
    return {"batcher": batcher, "reloader": reloader, "ladder": ladder,
            "finished": finished, "metrics": m, "seconds": dt}


def mesh_shape(ap, args) -> tuple[int, int] | None:
    """``--mesh``'s ``(dp, tp)``, after the reference's refusals (and
    ``None`` without it)."""
    if not args.mesh:
        return None
    try:
        dp, tp = (int(v) for v in args.mesh.split(","))
    except ValueError:
        ap.error(f"--mesh expects DP,TP (e.g. 2,2), got {args.mesh!r}")
    if dp < 1 or tp < 1:
        ap.error(f"--mesh: dp and tp must be >= 1, got dp={dp} tp={tp}")
    if args.kv_int8 and args.mesh_mode == "shard_map":
        ap.error("--kv-int8 prefill replay is served in gspmd mesh "
                 "mode only (drop --kv-int8 or use --mesh-mode gspmd)")
    if args.lut_fuse:
        ap.error("--lut-fuse is the single-device fast path — drop "
                 "--mesh (the sharded program keeps the gather-"
                 "shardable unfused form)")
    if args.reload_plan:
        ap.error("--reload-plan is single-device — the control plane "
                 "swaps jitted closures, not placed tables")
    try:
        rank_device(0, args.device)
    except RuntimeError as e:
        ap.error(str(e))
    return dp, tp


def main(argv=None) -> dict:
    ap = build_parser()
    args = parse_args(argv, ap)
    shape = mesh_shape(ap, args)
    if shape is not None:
        argv = list(sys.argv[1:] if argv is None else argv)
        if in_launched_rank():
            return serve_rank(make_host_mesh(
                *shape, device=join_from_env(args.device)), argv)
        ranks = run_ranks(serve_rank, (argv,), dp=shape[0], tp=shape[1],
                          device=args.device)
        return {"mesh": shape, "ranks": ranks}
    tel = open_telemetry(args)
    # the with-block lands the JSONL footer and the Prometheus dump even
    # on the sys.exit / ap.error paths inside _main
    with tel if tel is not None else nullcontext():
        return _main(ap, args, tel)


def _main(ap, args, tel) -> dict:
    log = obs_log
    try:
        cfg, params, batch, rng = setup(args)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    log.info("params", f"{cfg.name}: {param_summary(params)}")
    lut_tables = plans = None
    if args.tuned_plan:
        plans = load_plan(ap, args)
    elif args.lut_act:
        plans = build_plans(args, cfg, params, rng, tel=tel)
    if args.save_plan:
        if plans is None or args.tuned_plan:
            ap.error("--save-plan needs --lut-act plans built in-process "
                     "(a --tuned-plan artifact already is one)")
        frozen = save_tuned_plan(args.save_plan,
                                 tuned_plan_from_serving(cfg, plans))
        log.info("plan_saved", f"saved tuned plan -> {frozen} "
                 f"(reload-ready)", path=frozen)
    if plans is not None:
        cfg = plans.patched_config(cfg)
        lut_tables = serving_tables(args, plans, params.embed.device)
    if args.reload_plan:
        try:
            out = serve_with_reload(args, cfg, params, batch, lut_tables,
                                    plans)
        except NotImplementedError as e:   # a family the batcher refuses
            ap.error(f"--reload-plan: {e}")
        m = out["metrics"]
        if m["dropped"]:
            log.error("requests_dropped", f"ERROR: {m['dropped']} "
                      f"request(s) dropped across the reload",
                      dropped=m["dropped"])
            sys.exit(2)
        if not args.watch and not out["reloader"].counters["reloads_ok"]:
            log.error("reload_never_cutover", "ERROR: scheduled hot reload "
                      "never cut over — see the rejection records above")
            sys.exit(1)
        log.info("kernel_launches", f"kernel launches: {launch_counts()}",
                 **launch_counts())
        return out
    out = serve(args, cfg, params, batch, lut_tables)
    log.info("kernel_launches", f"kernel launches: {launch_counts()}",
             **launch_counts())
    return out


def serve_rank(mesh, argv, policy=None, eager: bool = False) -> dict:
    """One rank of ``--mesh`` serving (every rank runs it): rank 0 logs
    and writes the obs log; every rank returns its own record — its rows'
    tokens and last-position logits a step, the gathered tokens, memory at
    rest, launches, placement and the tables' checksum.  ``policy``: the
    table :class:`~repro_torch.serve.sharded.PlacementPolicy` of the
    ``gspmd`` mode (the reference's default without one).  Under NCCL the
    decode step is captured in a CUDA graph; ``eager=True`` decodes
    through the eager sharded step instead (the yardstick the captured
    step is held against)."""
    ap = build_parser()
    args = parse_args(argv, ap)
    rank0 = mesh.rank == 0
    log = obs_log if rank0 else Logger(lambda m: None)
    # every rank needs a telemetry for its monitor: its counters are summed
    # over the ranks when rank 0's log takes the drift rows
    tel = open_telemetry(args) if rank0 else (
        obs.Telemetry() if args.obs_log else None)
    with tel if tel is not None else nullcontext():
        out = _serve_rank(ap, args, mesh, log, tel, policy, eager)
    if tel is not None and tel.monitor is not None:
        out["drift_counts"] = tel.monitor.counts()
    return out


def _serve_rank(ap, args, mesh, log, tel, policy, eager) -> dict:
    import torch.distributed as dist

    from repro_torch import sites
    from repro_torch.serve.sharded import (
        ShardedServe,
        capture_refusal,
        init_params_sharded,
        rank_memory,
        shard_params,
        tables_checksum,
    )

    dev = mesh.device
    cfg = served_config(args)
    batch, rng = prompt_batch(args, cfg, dev)
    # rank 0 captures and compresses once (on the whole model only when it
    # calibrates); the ranks receive the plans
    full = None
    shared = [None, None]
    if mesh.rank == 0:
        if args.tuned_plan:
            shared[0] = load_plan(ap, args, log)
        elif args.lut_act:
            if calibrates(args):
                full = init_params(cfg, seed=0, device=dev)
            shared = list(compress_plans(args, cfg, full, rng, log=log))
    dist.broadcast_object_list(shared, src=0)
    plans, calib = shared
    if full is not None:
        params = shard_params(full, cfg, mesh)
        del full
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    else:
        params = init_params_sharded(cfg, 0, mesh, dev)
    synchronize(dev)
    at_rest = rank_memory(dev)
    lut_tables = None
    if plans is not None:
        cfg = plans.patched_config(cfg)
        lut_tables = plans.tables_for_model(backend=args.lut_backend,
                                            plan_exec=args.plan_exec,
                                            device=dev)
    checksum = tables_checksum(lut_tables)
    sums = [None] * mesh.size
    dist.all_gather_object(sums, checksum)
    if len(set(sums)) != 1:
        raise RuntimeError(f"--mesh: the ranks' table bytes differ "
                           f"(checksums {sums})")
    serve = ShardedServe(cfg, mesh, lut_tables, mode=args.mesh_mode,
                         policy=policy)
    ep = bool(cfg.moe) and cfg.moe.n_experts % mesh.shape["model"] == 0 \
        and mesh.shape["model"] > 1
    attach_monitor(args, tel, calib, dev, mesh,
                   split_kinds=(sites.EXPERT,) if ep else ())
    log.info("mesh_serving",
             f"mesh {mesh.shape} mode={args.mesh_mode} backend "
             f"{mesh.backend}; table placement:", mode=args.mesh_mode,
             backend=mesh.backend, dp=mesh.shape["data"],
             tp=mesh.shape["model"])
    for site, info in serve.placement.items():
        log.info("table_placement",
                 f"  {site}: {info['placement']} ({info['bytes']} B, "
                 f"{info['per_device_bytes']} B/dev)", site=site,
                 placement=info["placement"], bytes=info["bytes"])
    why = capture_refusal(mesh)
    if why is not None or eager:
        log.info("mesh_eager", "the sharded step runs eagerly: "
                 + (why or "asked for"), reason=why or "asked for")
    local = serve.place_batch(batch)
    b, t = local["tokens"].shape
    start = decode_start(cfg, local)
    max_seq = start + args.new_tokens
    with serve.session(params):
        out = _mesh_decode(args, cfg, serve, params, local, start, max_seq,
                           mesh, log, eager)
    log.info("mesh_gather", f"weights gathered once for the prefill and "
             f"the decode loop: {serve.gather_s:.4f}s",
             seconds=round(serve.gather_s, 4))
    named = dict(params.named_parameters())
    return dict(out, rank=mesh.rank, coords=mesh.coords(),
                backend=mesh.backend, device=str(dev), memory_at_rest=at_rest,
                memory_peak=(torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in named.values()),
                expert_bytes=sum(p.numel() * p.element_size()
                                 for n, p in named.items()
                                 if n.rsplit(".", 1)[-1].startswith("moe_")),
                launches=launch_counts(), placement=serve.placement,
                checksum=checksum, gather_s=serve.gather_s)


def _mesh_decode(args, cfg, serve, params, local, start, max_seq, mesh,
                 log, eager=False) -> dict:
    """The prefill and the greedy decode of one rank's rows, inside the
    serving session, through :meth:`~repro_torch.serve.sharded.
    ShardedServe.decode_fn`'s step (captured before the decode clock
    starts under NCCL, eager under gloo or with ``eager``): its tokens
    and logits, and the gathered tokens."""
    from repro_torch.serve.sharded import ShardedCapturedStep, gather_rows

    dev = local["tokens"].device
    b, t = local["tokens"].shape
    synchronize(dev)
    t0 = time.perf_counter()
    with obs.span("prefill", batch=b, prompt_len=t):
        logits, cache = serve.prefill(params, local, max_seq)
        synchronize(dev)
    prefill_s = time.perf_counter() - t0
    log.info("prefill", f"prefill {b}x{t} a data rank: {prefill_s:.4f}s",
             seconds=round(prefill_s, 4))
    if kv_int8_applies(args, cfg):
        cache = serve.place_cache(init_cache(
            cfg, args.batch, max_seq, device=dev, kv_dtype="int8"))
        log.info("kv_int8",
                 "int8 KV cache enabled (decode writes quantized entries)")
        logits, cache = serve.replay(params, cache, local["tokens"])
    tok = logits[:, -1].argmax(-1)[:, None]
    step = (lambda c, tk, pos: serve.decode(params, c, tk, pos)) if eager \
        else serve.decode_fn(params)
    capture_s = None
    if isinstance(step, ShardedCapturedStep):
        step.capture(cache, tok)
        capture_s = step.capture_s
        log.info("mesh_captured", f"the sharded decode step captured in a "
                 f"CUDA graph over NCCL: {capture_s:.4f}s",
                 seconds=round(capture_s, 4))
    toks, seen = [], [logits[:, -1].cpu()]
    synchronize(dev)
    t0 = time.perf_counter()
    with obs.span("decode", batch=b, new_tokens=args.new_tokens):
        for i in range(args.new_tokens):
            toks.append(tok)
            logits, cache = step(cache, tok, start + i)
            seen.append(logits[:, -1].cpu())
            tok = logits[:, -1].argmax(-1)[:, None]
        synchronize(dev)
    dt = time.perf_counter() - t0
    mine = torch.cat(toks, dim=1)
    tokens = gather_rows(mine, mesh).tolist()
    tok_s = args.new_tokens * args.batch / dt if dt > 0 else float("inf")
    log.info("decode", f"decode {args.new_tokens} tokens x {args.batch} "
             f"requests on the mesh: {dt:.4f}s ({tok_s:.1f} tok/s)",
             seconds=round(dt, 4), tok_s=round(tok_s, 2))
    log.info("request_tokens", f"request 0: {tokens[0]}", rid=0,
             tokens=tokens[0])
    log.info("kernel_launches", f"kernel launches (rank 0): "
             f"{launch_counts()}", **launch_counts())
    return {"tokens": tokens, "rank_tokens": mine.tolist(), "logits": seen,
            "prefill_s": prefill_s, "decode_s": dt, "decode_tok_s": tok_s,
            "capture_s": capture_s, "start": start}


if __name__ == "__main__":
    main(sys.argv[1:])
