"""Shared benchmark utilities: train, extract and mark a LUT-NN once per
(model, scale, device), cached in-process; compress it by one of the
paper's methods and score the result.

Counterpart of the reference's ``benchmarks/common.py``, with its own
copies of the constants.  Training, don't-care marking and every accuracy
run on the device (K7 there); compression runs on the host through the
port's engine, and every compressed table is rebuilt on the device at all
``2^w_in`` addresses (K5 for a decomposed plan, K6 for a plain one) and
checked against ``plan.reconstruct()``.

Defaults come from ``REPRO_BENCH_SCALE`` (``small`` or ``paper``) and
``REPRO_BENCH_WORKERS`` (engine worker processes, default 2), as in the
reference; explicit arguments override them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (
    CompressConfig,
    compress_network_report,
    rom_baseline_cost,
)
from repro_torch.data import make_jsc, make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.lutnn import (
    device_tables,
    extract_tables,
    mark_observed,
    network_table_specs,
    reconstruct_tables,
    table_accuracy,
    train_lutnn,
)
from repro_torch.lutnn.model import LUTNNConfig, paper_model

EXP_DIR = Path(__file__).resolve().parents[3] / "experiments" / "torch"

# Paper Table 1 models; "small" variants keep the family/geometry but
# shrink layer counts so the default bench run stays CPU-friendly.
SCALED_MODELS = {
    "paper": {
        "jsc-2l": lambda: paper_model("jsc-2l"),
        "jsc-5l": lambda: paper_model("jsc-5l"),
        "mnist": lambda: paper_model("mnist"),
    },
    "small": {
        "jsc-2l": lambda: paper_model("jsc-2l"),
        "jsc-5l": lambda: LUTNNConfig(
            name="jsc-5l", n_inputs=16, layer_sizes=(32, 32, 32, 16, 5),
            beta=4, fanin=3, beta0=7, fanin0=2),
        "mnist": lambda: LUTNNConfig(
            name="mnist", n_inputs=784, layer_sizes=(64, 25, 25, 25, 10),
            beta=2, fanin=6, beta0=2, fanin0=6),
    },
}

# (generator, training samples, test samples) per scale and model
DATA = {
    "paper": {"jsc-2l": (make_jsc, 100000, 20000),
              "jsc-5l": (make_jsc, 100000, 20000),
              "mnist": (make_mnist_like, 30000, 5000)},
    "small": {"jsc-2l": (make_jsc, 12000, 3000),
              "jsc-5l": (make_jsc, 12000, 3000),
              "mnist": (make_mnist_like, 8000, 2000)},
}

EPOCHS = {"paper": 25, "small": 15}

M_CANDIDATES = (8, 16, 32, 64)
LB_CANDIDATES = (0, 1, 2)

_CACHE: dict = {}


def bench_scale(scale: str | None = None) -> str:
    return scale or os.environ.get("REPRO_BENCH_SCALE", "small")


def bench_workers(workers: int | None = None) -> int:
    """Engine worker processes for benchmark compression runs."""
    if workers is None:
        workers = int(os.environ.get("REPRO_BENCH_WORKERS", "2"))
    return max(1, workers)


@dataclasses.dataclass
class TrainedNet:
    """A trained LUT-NN: tables ``(n_l, 2^w_in_l)`` int32, wiring ``(n_l,
    F_l)`` int32 and observed masks (bool, True = visited in training) as
    tensors on one device; the data ``(x_train, y_train, x_test, y_test)``
    as numpy."""

    cfg: LUTNNConfig
    conn: list
    tables: list
    observed: list
    data: tuple
    test_acc: float
    train_acc: float


def get_trained(model: str, scale: str | None = None,
                device=None) -> TrainedNet:
    """Train ``model`` at ``scale`` on ``device`` (the card unless the
    caller asks for another), extract its tables and mark its don't
    cares; cached per ``(model, scale, device)``."""
    scale = bench_scale(scale)
    dev = resolve_device(device)
    key = (model, scale, str(dev))
    if key in _CACHE:
        return _CACHE[key]
    cfg = SCALED_MODELS[scale][model]()
    make, n_train, n_test = DATA[scale][model]
    xtr, ytr, xte, yte = make(n_train, n_test)
    lutnn, conn, _ = train_lutnn(cfg, xtr, ytr, xte, yte,
                                 epochs=EPOCHS[scale], device=dev)
    tables = extract_tables(lutnn, cfg)
    conn = device_tables(conn, dev)
    observed = mark_observed(tables, conn, cfg, xtr)
    net = TrainedNet(
        cfg=cfg, conn=conn, tables=tables, observed=observed,
        data=(xtr, ytr, xte, yte),
        test_acc=table_accuracy(tables, conn, cfg, xte, yte),
        train_acc=table_accuracy(tables, conn, cfg, xtr, ytr),
    )
    _CACHE[key] = net
    return net


def random_fill(net: TrainedNet, seed: int = 0) -> list[torch.Tensor]:
    """The tables with every unobserved entry drawn at random, as the
    reference draws them (numpy, layer by layer), on the tables' device."""
    rng = np.random.default_rng(seed)
    tabs = []
    for t, o in zip(net.tables, net.observed):
        t, o = t.cpu().numpy(), o.cpu().numpy()
        tabs.append(np.where(o, t, rng.integers(0, 1 << net.cfg.beta,
                                                size=t.shape)))
    return device_tables(tabs, net.tables[0].device)


def compress_and_eval(net: TrainedNet, method: str, exiguity: int | None,
                      seed: int = 0, workers: int | None = None) -> dict:
    """method: baseline | compressedlut | reducedlut | random."""
    cfg, conn = net.cfg, net.conn
    xtr, ytr, xte, yte = net.data
    t0 = time.time()
    if method == "baseline":
        specs = network_table_specs(net.tables, None, cfg)
        cost = sum(rom_baseline_cost(s) for s in specs)
        return {
            "pluts": cost, "test_acc": net.test_acc,
            "train_acc": net.train_acc, "seconds": time.time() - t0,
        }
    if method == "random":
        tabs = random_fill(net, seed)
        return {
            "pluts": None,
            "test_acc": table_accuracy(tabs, conn, cfg, xte, yte),
            "train_acc": table_accuracy(tabs, conn, cfg, xtr, ytr),
            "seconds": time.time() - t0,
        }
    observed = None if method == "compressedlut" else net.observed
    ex = None if method == "compressedlut" else exiguity
    specs = network_table_specs(net.tables, observed, cfg)
    ccfg = CompressConfig(exiguity=ex, m_candidates=M_CANDIDATES,
                          lb_candidates=LB_CANDIDATES)
    report = compress_network_report(specs, ccfg,
                                     workers=bench_workers(workers))
    tabs = reconstruct_tables(report.plans, cfg, net.tables[0].device)
    return {
        "pluts": report.total_cost,
        "test_acc": table_accuracy(tabs, conn, cfg, xte, yte),
        "train_acc": table_accuracy(tabs, conn, cfg, xtr, ytr),
        "seconds": time.time() - t0,
        "compress_seconds": report.seconds,
        "workers": report.workers,
        "n_decomposed": report.n_decomposed,
        "eliminated": report.total_eliminated,
    }


def save_result(name: str, obj, out_dir=None) -> Path:
    """Write ``obj`` as ``<out_dir>/<name>.json`` (default
    ``experiments/torch/``); returns the path."""
    out = Path(out_dir) if out_dir is not None else EXP_DIR
    out.mkdir(parents=True, exist_ok=True)
    path = out / (name + ".json")
    path.write_text(json.dumps(obj, indent=1))
    return path
