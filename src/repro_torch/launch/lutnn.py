"""The paper's LUT-NN toolflow (Fig. 2) on one device: counterpart of the
reference's ``examples/lutnn_pipeline.py``.

  PYTHONPATH=src python -m repro_torch.launch.lutnn [--model jsc-2l] \\
      [--n-train 12000] [--n-test 3000] [--epochs 12] [--workers 2] \\
      [--verilog-out PATH] [--device cuda|cpu]

Steps: (1) train the LUT-NN on the device; (2) extract its truth tables
on the device; (3) mark the addresses the training set never visits as
don't cares, on the device; (4) compress on the host with the port's
engine — CompressedLUT (no don't cares) and ReducedLUT (exiguity 250);
(5) reconstruct every ReducedLUT plan's table at all ``2^w_in`` addresses
on the device (kernel K5 for a decomposed plan, K6 for a plain one) and
check it against ``plan.reconstruct()``; (6) table-network accuracy before
and after (kernel K7), with training accuracy required unchanged; (7) emit
Verilog (written to ``--verilog-out`` when given).  The run uses the card
unless ``--device cpu`` is given; on the CPU every kernel's plain version
runs instead.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core import (
    CompressConfig,
    compress_network_report,
    network_to_verilog,
    rom_baseline_cost,
)
from repro_torch.core.engine import shutdown_pools
from repro_torch.data import make_jsc, make_mnist_like
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import launch_counts
from repro_torch.lutnn import (
    device_tables,
    extract_tables,
    mark_observed,
    network_table_specs,
    reconstruct_tables,
    table_accuracy,
    train_lutnn,
)
from repro_torch.lutnn.model import PAPER_MODELS, paper_model

# the example's data sizes for JSC; the reference benchmarks' small scale
# for MNIST
DATA = {"jsc-2l": (make_jsc, 12000, 3000), "jsc-5l": (make_jsc, 12000, 3000),
        "mnist": (make_mnist_like, 8000, 2000)}
SEARCH = dict(m_candidates=(8, 16, 32, 64), lb_candidates=(0, 1, 2))
EXIGUITY = 250


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.lutnn")
    ap.add_argument("--model", choices=PAPER_MODELS, default="jsc-2l")
    ap.add_argument("--n-train", type=int, default=None,
                    help="training samples (default: 12000 JSC, 8000 MNIST)")
    ap.add_argument("--n-test", type=int, default=None,
                    help="test samples (default: 3000 JSC, 2000 MNIST)")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--workers", type=int, default=2,
                    help="engine worker processes for compression")
    ap.add_argument("--verilog-out", default=None,
                    help="write the ReducedLUT network's Verilog here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def run(args, log=print) -> dict:
    """The toolflow's steps; returns their results and seconds."""
    dev = resolve_device(args.device)
    cfg = paper_model(args.model)
    make, n_train, n_test = DATA[args.model]
    xtr, ytr, xte, yte = make(args.n_train or n_train,
                              args.n_test or n_test)
    seconds = {}
    out = {"model": cfg.name, "device": str(dev), "seconds": seconds,
           "samples": {"train": len(xtr), "test": len(xte)},
           "layers": len(cfg.layer_sizes)}
    last = time.perf_counter()

    def step(name):
        """Close step ``name``: the seconds since the previous one."""
        nonlocal last
        synchronize(dev)
        now = time.perf_counter()
        seconds[name] = now - last
        last = now

    log(f"1. training {cfg.name} ({'+'.join(map(str, cfg.layer_sizes))} "
        f"neurons, beta={cfg.beta}, F={cfg.fanin}) on {dev}: "
        f"{len(xtr)} train / {len(xte)} test samples, {args.epochs} epochs")
    model, conn, metrics = train_lutnn(cfg, xtr, ytr, xte, yte,
                                       epochs=args.epochs, device=dev)
    step("train")
    log(f"   train acc {metrics['train_acc']:.4f}  "
        f"test acc {metrics['test_acc']:.4f}")
    out["train"] = metrics

    log("2. extracting truth tables")
    tables = extract_tables(model, cfg)
    step("extract")
    log("3. marking don't cares")
    conn_d = device_tables(conn, dev)
    observed = mark_observed(tables, conn_d, cfg, xtr)
    dc = [float(1 - o.float().mean()) for o in observed]
    step("dont_cares")
    log(f"   don't-care fraction per layer: {[f'{d:.2f}' for d in dc]}")
    out["dontcare_frac"] = dc

    log(f"4. compressing network ({cfg.n_luts} L-LUTs, engine "
        f"workers={args.workers})")
    specs_ac = network_table_specs(tables, None, cfg)
    specs_dc = network_table_specs(tables, observed, cfg)
    baseline = sum(rom_baseline_cost(s) for s in specs_ac)
    rep_c = compress_network_report(
        specs_ac, CompressConfig(exiguity=None, **SEARCH),
        workers=args.workers)
    rep_r = compress_network_report(
        specs_dc, CompressConfig(exiguity=EXIGUITY, **SEARCH),
        workers=args.workers)
    shutdown_pools()
    step("compress")
    cost_c, cost_r = rep_c.total_cost, rep_r.total_cost
    log(f"   CompressedLUT: {rep_c.summary()}")
    log(f"   ReducedLUT:    {rep_r.summary()}")
    log(f"   baseline {baseline} | CompressedLUT {cost_c} "
        f"({1 - cost_c / baseline:.0%} saved) | ReducedLUT {cost_r} "
        f"({1 - cost_r / baseline:.0%} saved, "
        f"{1 - cost_r / cost_c:.0%} vs CompressedLUT)")
    plans_r = rep_r.plans
    out["plan_list"] = plans_r
    out["pluts"] = {"baseline": baseline, "compressedlut": cost_c,
                    "reducedlut": cost_r}
    out["plans"] = {"decomposed": sum(p.kind == "decomposed"
                                      for p in plans_r),
                    "plain": sum(p.kind == "plain" for p in plans_r)}

    log("5. reconstructing the ReducedLUT tables at every address")
    tab_r = reconstruct_tables(plans_r, cfg, dev)
    step("reconstruct")
    log(f"   {len(plans_r)} tables equal plan.reconstruct() "
        f"({out['plans']['decomposed']} decomposed, "
        f"{out['plans']['plain']} plain)")

    log("6. accuracy on the table network")
    acc = {"test_before": table_accuracy(tables, conn_d, cfg, xte, yte),
           "test_after": table_accuracy(tab_r, conn_d, cfg, xte, yte),
           "train_before": table_accuracy(tables, conn_d, cfg, xtr, ytr),
           "train_after": table_accuracy(tab_r, conn_d, cfg, xtr, ytr)}
    step("accuracy")
    log(f"   test acc {acc['test_before']:.4f} -> {acc['test_after']:.4f}  "
        f"train acc {acc['train_before']:.4f} -> {acc['train_after']:.4f} "
        f"(must be equal)")
    if acc["train_before"] != acc["train_after"]:
        raise AssertionError(
            f"training accuracy changed under ReducedLUT: "
            f"{acc['train_before']} -> {acc['train_after']}")
    out["accuracy"] = acc

    log("7. emitting Verilog")
    v = network_to_verilog(plans_r)
    if args.verilog_out:
        with open(args.verilog_out, "w") as f:
            f.write(v)
    step("verilog")
    log(f"   {len(v.splitlines())} lines"
        + (f", written to {args.verilog_out}" if args.verilog_out else ""))
    out["verilog_lines"] = len(v.splitlines())
    log("seconds per step: " + ", ".join(f"{k} {s:.3f}"
                                         for k, s in seconds.items()))
    return out


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    out = run(args)
    print(f"kernel launches: {launch_counts()}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
