"""The hill climb over the dry run (the port's counterpart of the
reference's ``launch/hillclimb.py``).

Runs the reference's named variants of three (arch x shape) cells on the
single-pod production mesh, traces each through the dry run
(:mod:`repro_torch.launch.dryrun`) and records its roofline terms beside
the cached baselines.  Each variant is one hypothesis: a microbatch
count, the fast stream (:func:`repro_torch.nn.layers.set_fast_stream`),
the WKV chunk (:func:`repro_torch.nn.ssm.set_wkv_chunk`), an int8 KV
cache, a LUT activation or gradient compression.  The reference's
sequence-parallel variants have no counterpart yet: the port resolves
the ``"sp"`` axis to replicated (ROADMAP queue A, item 13: sequence
parallelism), so they are recorded with status ``"skipped"`` and that
reason.  The levers are reset after every variant.  Model numbers from an H100's peaks, not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--only rwkv6-3b]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np

OUT_DIR = "experiments/torch/hillclimb"

SEQ_PARALLEL_SKIP = (
    "sequence parallelism is not ported: the port resolves the 'sp' axis "
    "to replicated (ROADMAP queue A, item 13: sequence parallelism)")


def _lut_tables(cfg):
    """The reference's hill-climb LUT: one shared SiLU (relu2) table, on
    the ``cuda`` backend (K2)."""
    import dataclasses

    from repro_torch.nn.lut_act import build_lut_activation

    calib = np.random.default_rng(0).normal(size=200000) * 2.5
    lut = build_lut_activation(
        "relu2" if cfg.activation == "relu2" else "silu",
        calib, w_in=10, w_out=10, x_lo=-8.0, x_hi=8.0)
    return dataclasses.replace(cfg, lut_activation=True), lut


def run_variant(arch, shape, name, *, microbatch=None, fast_stream=False,
                kv_dtype="bfloat16", lut_act=False, grad_compress=False,
                wkv_chunk=None, seq_parallel=False, out_dir=OUT_DIR,
                cfg=None, info=None, mesh_shape=None):
    """Trace one variant and write its JSON under ``out_dir``; ``cfg`` /
    ``info`` / ``mesh_shape`` override the config, the shape and the mesh
    as in :func:`~repro_torch.launch.dryrun.dryrun_cell` (the tests'
    smoke cells)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import SHAPES, dryrun_cell
    from repro_torch.nn.layers import set_fast_stream
    from repro_torch.nn.ssm import set_wkv_chunk
    from repro_torch.roofline import model_flops_per_step
    from repro_torch.train import TrainConfig

    base = cfg or get_config(arch)
    info = info or SHAPES[shape]
    res = {"arch": arch, "shape": shape, "variant": name}
    if seq_parallel:
        res.update(status="skipped", reason=SEQ_PARALLEL_SKIP)
        print(f"  [{arch} {shape} {name}] skipped: sequence parallelism")
        return _save(res, out_dir)
    set_fast_stream(fast_stream)
    if wkv_chunk:
        set_wkv_chunk(wkv_chunk)
    try:
        t0 = time.time()
        tcfg, tables, cfg_v = None, None, base
        if info["kind"] == "train":
            tcfg = TrainConfig(microbatch=microbatch, remat=True,
                               grad_compress=grad_compress)
        elif lut_act:
            cfg_v, lut = _lut_tables(base)
            tables = {"backend": "cuda",
                      "sites": {"mlp": lut.tables_for_model("meta")}}
        cell = dryrun_cell(arch, shape, False, tcfg=tcfg, quiet=True,
                           cfg=cfg_v, info=info, mesh_shape=mesh_shape,
                           kv_dtype=kv_dtype, lut_tables=tables)
        if cell["status"] != "ok":
            raise RuntimeError(cell.get("error", cell["status"]))
        rf = cell["roofline"]
        res.update({
            "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "roofline": rf,
            "model_flops": model_flops_per_step(
                base, info["batch"], info["seq"], info["kind"]),
            "n_chips": cell["n_chips"],
            "peak_bytes": cell["peak_bytes"],
            "launches": cell["launches"],
        })
        print(f"  [{arch} {shape} {name}] compute={rf['compute_s']:.3e} "
              f"memory={rf['memory_s']:.3e} "
              f"coll={rf['collective_s']:.3e} dominant={rf['dominant']}")
    except Exception as e:  # noqa: BLE001
        res.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-1500:])
        print(f"  [{arch} {shape} {name}] ERROR {res['error'][:120]}")
    finally:
        set_fast_stream(False)
        set_wkv_chunk(64)
    return _save(res, out_dir)


def _save(res: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{res['arch']}__{res['shape']}__{res['variant']}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


EXPERIMENTS = [
    # H1 — worst roofline fraction: rwkv6-3b train_4k
    ("rwkv6-3b", "train_4k", "v1_micro4", dict(microbatch=4)),
    ("rwkv6-3b", "train_4k", "v2_micro4_fast",
     dict(microbatch=4, fast_stream=True)),
    ("rwkv6-3b", "train_4k", "v3_micro2_fast",
     dict(microbatch=2, fast_stream=True)),
    # iter2: pairwise decay tensor traffic is linear in the WKV chunk
    ("rwkv6-3b", "train_4k", "v4_chunk16", dict(wkv_chunk=16)),
    ("rwkv6-3b", "train_4k", "v5_chunk8", dict(wkv_chunk=8)),
    # closing iterations (stopping rule: 3 consecutive <5%)
    ("rwkv6-3b", "train_4k", "v6_chunk4", dict(wkv_chunk=4)),
    # H2 — most collective-bound: deepseek-67b train_4k
    ("deepseek-67b", "train_4k", "v1_micro8", dict(microbatch=8)),
    ("deepseek-67b", "train_4k", "v2_micro8_fast",
     dict(microbatch=8, fast_stream=True)),
    # iter3: Megatron sequence parallelism — AR -> RS + AG
    ("deepseek-67b", "train_4k", "v3_sp", dict(seq_parallel=True)),
    ("deepseek-67b", "train_4k", "v4_sp_fast",
     dict(seq_parallel=True, fast_stream=True)),
    # H3 — paper-representative: nemotron decode_32k serving path
    ("nemotron-4-15b", "decode_32k", "v1_fast", dict(fast_stream=True)),
    ("nemotron-4-15b", "decode_32k", "v2_fast_int8",
     dict(fast_stream=True, kv_dtype="int8")),
    ("nemotron-4-15b", "decode_32k", "v3_fast_int8_lut",
     dict(fast_stream=True, kv_dtype="int8", lut_act=True)),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--skip-cached", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    for arch, shape, name, kw in EXPERIMENTS:
        if args.only and args.only not in arch:
            continue
        path = os.path.join(args.out, f"{arch}__{shape}__{name}.json")
        if args.skip_cached and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skipped"):
                    print(f"  [cached] {arch} {shape} {name}")
                    continue
        run_variant(arch, shape, name, out_dir=args.out, **kw)


if __name__ == "__main__":
    main()
