"""Training launcher of the port (counterpart of the reference's
``launch/train.py``), on one device or a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 8 --seq 128 [--full] [--microbatch M] \\
      [--remat] [--grad-compress] [--ckpt-dir D] [--ckpt-every N] \\
      [--dp DP --tp TP | --production-mesh [--multi-pod]] \\
      [--tp-mode exact|partitioned] [--device cuda|cpu]

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
``--device cpu``.

``--dp`` / ``--tp`` above 1 train on a ``(data, model)`` mesh of ``DP x
TP`` ranks (:mod:`repro_torch.launch.mesh`): spawned from here, or started
by ``torchrun`` (each rank joins from its environment).  Each rank holds
its shares of the state and runs the sharded step of
:mod:`repro_torch.train.step` on its rows of the one global batch stream;
rank 0 prints the lines and writes the checkpoints.  ``--tp-mode``
picks the step's mode on the model axis: ``exact`` (the default: every
weight gathered, the single-device bits) or ``partitioned`` (every
family: each rank keeps its tp share of the split weights in the
compute, as the reference's GSPMD step does; the reference has only
that mode).
``--production-mesh``
builds the reference's 16 x 16 mesh (``--multi-pod`` its 2 x 16 x 16), so
it needs 256 (512) ranks started by ``torchrun``; with any other count
the launcher exits with status 2 naming the count, as the reference's
``jax.make_mesh`` raises.  A rank that fails fails the run: no fallback
to one device or to the CPU.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.mesh import (
    in_launched_rank,
    join_from_env,
    make_host_mesh,
    make_production_mesh,
    run_ranks,
)
from repro_torch.nn.transformer import _flat_defs, param_defs
from repro_torch.optim import AdamWConfig, warmup_cosine_schedule
from repro_torch.train import (
    Supervisor,
    TrainConfig,
    init_train_state,
    make_train_step,
    train_state_shardings,
)


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
    ap.add_argument("--tp-mode", choices=("exact", "partitioned"),
                    default="exact",
                    help="exact (default): gathered weights, the "
                         "single-device bits; partitioned: the tp "
                         "shares in the compute (every family)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def production_ranks(args) -> int:
    """Ranks of the reference's production mesh: 16 x 16, two pods 512."""
    return 512 if args.multi_pod else 256


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the flags.  Exits with status 2 on a mesh that cannot be
    built here: ``--dp`` / ``--tp`` below 1, ``--multi-pod`` without
    ``--production-mesh`` (the reference ignores it there), a production
    mesh without its 256 (512) ranks, or ``torchrun`` ranks that do not
    make ``DP x TP``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.dp < 1 or args.tp < 1:
        ap.error(f"--dp and --tp must be >= 1, got --dp {args.dp} "
                 f"--tp {args.tp}")
    world = int(os.environ["WORLD_SIZE"]) if in_launched_rank() else 1
    if args.multi_pod and not args.production_mesh:
        ap.error("--multi-pod selects the two-pod production mesh (2 x 16 "
                 "x 16, 512 ranks): add --production-mesh")
    if args.production_mesh:
        if args.dp > 1 or args.tp > 1:
            ap.error("--production-mesh fixes the mesh; drop --dp / --tp")
        n = production_ranks(args)
        if world != n:
            ap.exit(2, f"{ap.prog}: error: --production-mesh"
                       f"{' --multi-pod' if args.multi_pod else ''} needs "
                       f"{n} ranks (torchrun --nnodes ... "
                       f"--nproc-per-node ...), {world} running\n")
    elif in_launched_rank() and world != args.dp * args.tp:
        ap.exit(2, f"{ap.prog}: error: --dp {args.dp} --tp {args.tp} needs "
                   f"{args.dp * args.tp} ranks, torchrun started {world}\n")
    return args


def on_mesh(args) -> bool:
    return args.production_mesh or args.dp * args.tp > 1


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


def setup(args, cfg=None, mesh=None) -> dict:
    """Config, train config, a fresh state (seed 0) on the device, the
    step and the batch function.  ``cfg`` overrides the one the flags
    name (a depth cut).  On a ``mesh`` the state is this rank's shares
    (``"shardings"`` their placements), the step the sharded one and the
    batches the global ones."""
    dev = resolve_device(mesh.device if mesh is not None else args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full:
            cfg = smoke_config(cfg)
    tcfg = train_config(args)
    state = init_train_state(cfg, tcfg, device=dev, mesh=mesh)
    return {"cfg": cfg, "tcfg": tcfg, "device": dev, "state": state,
            "mesh": mesh,
            "shardings": (train_state_shardings(cfg, tcfg, mesh)
                          if mesh is not None else None),
            "step": make_train_step(cfg, tcfg, dev, mesh=mesh,
                                    tp_mode=args.tp_mode),
            "batch_at": batch_fn(cfg, args)}


def state_bytes(state: dict) -> int:
    """Bytes of the state's tensors (a rank's shares on a mesh)."""
    ts = list(state["params"].parameters()) + state["opt"]["mu"] \
        + state["opt"]["nu"] + state.get("ef_error", [])
    return sum(t.numel() * t.element_size() for t in ts)


def _ckpt_dir(args, mesh) -> str:
    """``--ckpt-dir`` or a new temporary directory, rank 0's on a mesh."""
    d = [args.ckpt_dir or (tempfile.mkdtemp(prefix="repro_torch_train_")
                           if mesh is None or mesh.rank == 0 else None)]
    if mesh is not None:
        import torch.distributed as dist

        dist.broadcast_object_list(d, src=0)
    return d[0]


def run(args, run_setup: dict | None = None, log=print,
        supervisor: Supervisor | None = None, step_fn=None) -> dict:
    """Train ``args.steps`` steps under the supervisor.  Returns ``{"state",
    "stats", "losses", "grad_norms" (floats, a step), "seconds" (a step,
    host clock with the device synchronized), "splits" (a step, the
    sharded step's seconds by part; empty on one device), "ckpt_dir"}``.
    ``step_fn`` replaces the train step (to inject a failure)."""
    s = run_setup or setup(args)
    cfg, dev, mesh = s["cfg"], s["device"], s.get("mesh")
    n_params = sum(math.prod(d.shape)
                   for _, d, _ in _flat_defs(param_defs(cfg)))
    where = f"mesh={mesh.shape}" if mesh is not None else ""
    log(f"arch={cfg.name} (~{n_params / 1e6:.1f}M params) device={dev} "
        f"{where + ' ' if where else ''}steps={args.steps} "
        f"batch={args.batch}x{args.seq} remat={args.remat} "
        f"microbatch={args.microbatch} grad_compress={args.grad_compress}"
        + (f" tp_mode={args.tp_mode}" if mesh is not None else ""))
    losses, norms, seconds, splits = {}, {}, {}, {}
    inner = step_fn or s["step"]
    timings = getattr(s["step"], "timings", None)

    def timed_step(state, batch):
        t0 = time.perf_counter()
        state, m = inner(state, batch)
        synchronize(dev)
        seconds[state["step"] - 1] = time.perf_counter() - t0
        if timings is not None:
            splits[state["step"] - 1] = dict(timings)
        return state, m

    def on_metrics(step, m):
        losses[step] = float(m["loss"])
        norms[step] = float(m["grad_norm"])
        if step % 10 == 0 or step == args.steps - 1:
            log(f"  step {step:5d} loss {losses[step]:.4f} "
                f"grad_norm {norms[step]:.4f} lr {float(m['lr']):.2e}")

    sup = supervisor or Supervisor(_ckpt_dir(args, mesh),
                                   ckpt_every=args.ckpt_every,
                                   shardings=s.get("shardings"))
    ckpt = sup.ckpt_dir
    state, stats = sup.run(s["state"], timed_step, s["batch_at"],
                           args.steps, on_metrics=on_metrics)
    log(f"finished at step {state['step']}; checkpoints in {ckpt}; "
        f"stragglers={stats['stragglers']} restarts={stats['restarts']}")
    ordered = lambda d: [d[k] for k in sorted(d)]
    return {"state": state, "stats": stats, "losses": ordered(losses),
            "grad_norms": ordered(norms), "seconds": ordered(seconds),
            "splits": ordered(splits), "ckpt_dir": ckpt}


def train_rank(mesh, argv) -> dict:
    """One rank of a mesh run (every rank runs it): rank 0 logs; every
    rank returns :func:`run`'s record without the state, with its state
    bytes and card memory at rest and at peak."""
    from repro_torch.serve.sharded import rank_memory

    args = parse_args(argv)
    s = setup(args, mesh=mesh)
    synchronize(s["device"])
    at_rest = rank_memory(s["device"])
    out = run(args, s, log=print if mesh.rank == 0 else (lambda m: None))
    dev = s["device"]
    peak = None
    if dev.type == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated(dev)
    return dict({k: v for k, v in out.items() if k != "state"},
                rank=mesh.rank, coords=mesh.coords(),
                state_bytes=state_bytes(out["state"]),
                memory_at_rest=at_rest, memory_peak=peak)


def train_mesh(argv) -> list:
    """``argv``'s mesh run: this process's rank under ``torchrun`` (a list
    of one record), else ``DP x TP`` spawned ranks (their records in rank
    order)."""
    args = parse_args(argv)
    if in_launched_rank():
        dev = join_from_env(args.device)
        mesh = (make_production_mesh(multi_pod=args.multi_pod, device=dev)
                if args.production_mesh
                else make_host_mesh(args.dp, args.tp, device=dev))
        return [train_rank(mesh, argv)]
    return run_ranks(train_rank, (list(argv),), dp=args.dp, tp=args.tp,
                     device=args.device or "cuda")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if on_mesh(args):
        train_mesh(argv)
    else:
        run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
