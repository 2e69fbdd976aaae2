"""Training launcher of the port (counterpart of the reference's
``launch/train.py`` on one device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 8 --seq 128 [--full] [--microbatch M] \\
      [--remat] [--grad-compress] [--ckpt-dir D] [--ckpt-every N] \\
      [--device cuda|cpu]

The reference's flags and defaults; the model is the smoke config unless
``--full``.  Batches come from :class:`repro_torch.data.TokenStream`
(seed 0), so a restart from a checkpoint resumes the stream exactly; a
vlm batch adds patch embeddings and an encdec batch audio frames, drawn
from ``(seed, step)`` as well (the reference's launcher streams tokens
only, which its encdec loss cannot take).  The learning rate follows the
reference's warmup-cosine schedule (``--lr`` peak, a tenth of the steps
of warmup); the loop is :class:`repro_torch.train.Supervisor`
(checkpoints every ``--ckpt-every`` steps and at the end, restart from
the latest on failure, straggler monitor).  It runs on the card unless
``--device cpu``.  Data- and tensor-parallel meshes (``--dp`` / ``--tp``
above 1, ``--production-mesh``, ``--multi-pod``) wait for sharded
training (ROADMAP queue A, item 11): the launcher exits with status 2.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device, synchronize
from repro_torch.optim import AdamWConfig, warmup_cosine_schedule
from repro_torch.train import (
    Supervisor,
    TrainConfig,
    init_train_state,
    make_train_step,
)

SHARDED = "sharded training waits for ROADMAP queue A, item 11"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the smoke "
                         "config)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the flags; a mesh beyond one device exits with status 2."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.dp > 1 or args.tp > 1 or args.production_mesh or args.multi_pod:
        ap.exit(2, f"{ap.prog}: error: --dp {args.dp} --tp {args.tp}"
                   f"{' --production-mesh' if args.production_mesh else ''}"
                   f"{' --multi-pod' if args.multi_pod else ''}: {SHARDED}"
                   f"\n")
    return args


def train_config(args) -> TrainConfig:
    """The reference launcher's ``TrainConfig``: AdamW on the
    warmup-cosine schedule (peak ``--lr``, ``steps // 10`` of warmup)."""
    return TrainConfig(
        optimizer=AdamWConfig(lr=warmup_cosine_schedule(
            args.lr, max(1, args.steps // 10), args.steps)),
        remat=args.remat,
        microbatch=args.microbatch,
        grad_compress=args.grad_compress,
    )


def batch_fn(cfg, args, seed: int = 0):
    """``step -> batch`` (numpy): the token stream's batch, and for vlm
    the patch embeddings, for encdec the audio frames, from ``(seed,
    step)``."""
    stream = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=seed)

    def at(step: int) -> dict:
        batch = stream.batch_at(step)
        extra = {"vlm": ("patches", cfg.n_patches),
                 "encdec": ("frames", cfg.n_frames)}.get(cfg.family)
        if extra:
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, step, 1]))
            batch[extra[0]] = rng.normal(
                size=(args.batch, extra[1], cfg.d_model)).astype(np.float32)
        return batch

    return at


def setup(args, cfg=None) -> dict:
    """Config, train config, a fresh state (seed 0) on the device, the
    step and the batch function.  ``cfg`` overrides the one the flags
    name (a depth cut)."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full:
            cfg = smoke_config(cfg)
    tcfg = train_config(args)
    state = init_train_state(cfg, tcfg, device=dev)
    return {"cfg": cfg, "tcfg": tcfg, "device": dev, "state": state,
            "step": make_train_step(cfg, tcfg, dev),
            "batch_at": batch_fn(cfg, args)}


def run(args, run_setup: dict | None = None, log=print,
        supervisor: Supervisor | None = None, step_fn=None) -> dict:
    """Train ``args.steps`` steps under the supervisor.  Returns ``{"state",
    "stats", "losses", "grad_norms" (floats, a step), "seconds" (a step,
    host clock with the device synchronized), "ckpt_dir"}``.  ``step_fn``
    replaces the train step (to inject a failure)."""
    s = run_setup or setup(args)
    cfg, dev = s["cfg"], s["device"]
    n_params = sum(p.numel() for p in s["state"]["params"].parameters())
    log(f"arch={cfg.name} (~{n_params / 1e6:.1f}M params) device={dev} "
        f"steps={args.steps} batch={args.batch}x{args.seq} "
        f"remat={args.remat} microbatch={args.microbatch} "
        f"grad_compress={args.grad_compress}")
    losses, norms, seconds = {}, {}, {}
    inner = step_fn or s["step"]

    def timed_step(state, batch):
        t0 = time.perf_counter()
        state, m = inner(state, batch)
        synchronize(dev)
        seconds[state["step"] - 1] = time.perf_counter() - t0
        return state, m

    def on_metrics(step, m):
        losses[step] = float(m["loss"])
        norms[step] = float(m["grad_norm"])
        if step % 10 == 0 or step == args.steps - 1:
            log(f"  step {step:5d} loss {losses[step]:.4f} "
                f"grad_norm {norms[step]:.4f} lr {float(m['lr']):.2e}")

    sup = supervisor or Supervisor(
        args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_"),
        ckpt_every=args.ckpt_every)
    ckpt = sup.ckpt_dir
    state, stats = sup.run(s["state"], timed_step, s["batch_at"],
                           args.steps, on_metrics=on_metrics)
    log(f"finished at step {state['step']}; checkpoints in {ckpt}; "
        f"stragglers={stats['stragglers']} restarts={stats['restarts']}")
    return {"state": state, "stats": stats,
            "losses": [losses[k] for k in sorted(losses)],
            "grad_norms": [norms[k] for k in sorted(norms)],
            "seconds": [seconds[k] for k in sorted(seconds)],
            "ckpt_dir": ckpt}


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
