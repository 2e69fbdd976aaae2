"""Multi-pod dry run: trace one rank's step of every (arch x shape x mesh)
cell on tensors without data (the port's counterpart of the reference's
``launch/dryrun.py``).

The reference lowers and compiles an XLA program against
``ShapeDtypeStruct`` inputs and reads its HLO.  The port has no HLO: a
cell joins a fake process group of the production mesh's 256 (512) ranks
as rank 0 (``torch.distributed``'s ``"fake"`` backend: nothing is sent,
no peer runs), builds :func:`~repro_torch.launch.mesh.
make_production_mesh` on it and runs one train step, prefill or decode
step of its own program at the cell's shape and the config's full widths,
eagerly, on the ``meta`` device (tensors with shapes, strides and dtypes
and no data), with the kernels' abstract route
(:mod:`repro_torch.kernels.abstract`), the roofline's cost counter
(:mod:`repro_torch.roofline.costs`) and ``MemTracker`` watching.  Nothing
is allocated.  Fake ``cuda`` tensors (``FakeTensorMode``) do not serve:
a build of torch without CUDA cannot differentiate them (autograd asks
the device's guard for a stream), and their ``einsum`` gives a size-1 dim
another stride than eager's, so a product the card folds into one ``mm``
becomes a ``bmm`` over an expanded weight; a meta tensor runs eager's own
composite operations, and ``chip_smoke.py`` phase 24 finds the card's
step counting what the trace counts.  The layer and microbatch loops are
Python loops, so every iteration is traced and the counts need no loop
multiplier.  Everything
goes through the normal entry points: :func:`~repro_torch.train.
abstract_train_state` and :func:`~repro_torch.train.make_train_step`,
:class:`~repro_torch.serve.sharded.ShardedServe`'s prefill and decode,
:mod:`repro_torch.nn.sharding`'s collectives and the ``cuda`` backend of
the LUT sites.

The cell's JSON keeps the reference's schema, so either package's
``roofline.report`` reads it: ``lower_s`` is the trace's seconds and
``compile_s`` 0; ``memory.argument_size_in_bytes`` is the rank's state
and inputs at rest and ``temp_size_in_bytes`` the traced peak less that;
the port adds ``peak_bytes``, ``fits_80gb`` and ``launches`` (a kernel
point).  A rank that needs more than a card holds is recorded, not an
error, as the reference records ``memory_analysis`` without judging it.
These are model numbers from an H100's peaks, not measurements.

A training cell traces the train step in either mode of
:func:`~repro_torch.train.make_train_step`: ``--tp-mode exact`` (the
default; every weight gathered at the step's entry) or ``partitioned``
(the tp shares in the compute, as the reference's GSPMD step runs
them: every family); a partitioned cell records ``"tp_mode"`` in its
JSON and its file name ends in ``__part``, and a cell the mode does not
cover (a serving shape) is skipped with the reason.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--multi-pod] [--out experiments/torch/dryrun] \\
      [--tp-mode partitioned]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--lut-act]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import resource
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.roofline import analyze_costs, model_flops_per_step

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# device memory of one H100 (80 GB), the bar of ``fits_80gb``
CARD_BYTES = 80 * 10**9


def cell_supported(cfg, shape: str, tp_mode: str = "exact"
                   ) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "full attention at 524k decode is O(T) cache: skipped per assignment (noted in DESIGN.md)"
    if tp_mode == "partitioned" and SHAPES[shape]["kind"] != "train":
        return False, ("tp_mode partitioned is the train step's; serving "
                       "runs exact mode")
    return True, ""


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """Join a fake process group of ``world`` ranks as ``rank``
    (``torch.distributed``'s testing backend: collectives return at once
    and no other rank runs), and leave it after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already joined")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> list:
    """Every tensor in ``tree`` (dicts, lists, tuples, parameter
    modules)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _storages(tree) -> dict:
    """``{storage key: bytes}`` of the tensors in ``tree``, each storage
    once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def _n_dp(mesh) -> int:
    from repro_torch.nn.sharding import DP_AXES

    return math.prod(mesh.shape.get(a, 1) for a in DP_AXES)


def _serve_inputs(cfg, kind: str, batch: int, seq: int, srv, dev,
                  kv_dtype: str):
    """A rank's parameters and inputs of a prefill or decode step without
    data, placed by ``srv`` (a :class:`~repro_torch.serve.sharded.
    ShardedServe`, ``None`` for one device): ``(params, args)``."""
    from repro_torch.nn.transformer import abstract_params
    from repro_torch.serve.kvcache import abstract_cache
    from repro_torch.serve.sharded import serve_param_shardings
    from repro_torch.train.step import abstract_batch

    params = abstract_params(cfg, dev, None if srv is None
                             else serve_param_shardings(cfg, srv.mesh))
    place = (lambda b: b) if srv is None else srv.place_batch
    if kind == "prefill":
        b = abstract_batch(cfg, batch, seq, dev)
        b.pop("labels")
        return params, (place(b),)
    cache = abstract_cache(cfg, batch, seq, device=dev,
                           kv_dtype="int8" if kv_dtype == "int8" else None)
    tok = place({"tokens": torch.zeros((batch, 1), dtype=torch.long,
                                       device=dev)})["tokens"]
    if srv is not None:
        cache = srv.place_cache(cache)
    pos = torch.tensor(seq - 1, dtype=torch.long, device=dev)
    return params, (cache, tok, pos)


def trace_step(cfg, kind: str, batch: int, seq: int, *, mesh=None,
               tcfg=None, lut_tables=None, kv_dtype: str = "bfloat16",
               device="meta", tp_mode: str = "exact") -> dict:
    """Trace one rank's step of ``kind`` (``"train"``, ``"prefill"``,
    ``"decode"``) at ``batch`` x ``seq`` without data: ``{"costs",
    "terms", "argument_bytes", "output_bytes", "alias_bytes",
    "peak_bytes", "trace_s"}``.  ``mesh`` ``None`` traces the
    single-device program; ``lut_tables`` (decode and prefill; on the
    trace's device, built inside ``ops.abstract()``) are served on their
    backend.  ``device``: ``meta``, the card's program; inside a
    ``FakeTensorMode`` another device traces its own program on fake
    tensors (``"cpu"``: the plain versions).  ``tp_mode``: the train
    step's (:func:`~repro_torch.train.make_train_step`)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.kernels import ops
    from repro_torch.roofline.costs import count_costs

    dev = torch.device(device)
    if kind == "train":
        from repro_torch.train import (
            TrainConfig,
            abstract_batch,
            abstract_train_state,
            make_train_step,
        )

        tcfg = tcfg or TrainConfig()
        state = abstract_train_state(cfg, tcfg, dev, mesh)
        gbatch = abstract_batch(cfg, batch, seq, dev)
        step = make_train_step(cfg, tcfg, dev, mesh=mesh, tp_mode=tp_mode)
        rest = (state, gbatch)
        run = lambda: step(state, gbatch)
    else:
        from repro_torch.serve.decode import decode_step, prefill
        from repro_torch.serve.sharded import ShardedServe

        srv = (None if mesh is None else
               ShardedServe(cfg, mesh, lut_tables, kv_dtype=kv_dtype))
        params, args = _serve_inputs(cfg, kind, batch, seq, srv, dev,
                                     kv_dtype)
        if srv is not None:
            tables = srv.tables
            fn = srv.prefill if kind == "prefill" else srv.decode
            run = ((lambda: fn(params, *args, max_seq=seq))
                   if kind == "prefill" else lambda: fn(params, *args))
        else:
            tables = lut_tables
            run = ((lambda: prefill(params, cfg, *args, max_seq=seq,
                                    lut_tables=tables))
                   if kind == "prefill" else
                   lambda: decode_step(params, cfg, *args,
                                       lut_tables=tables))
        rest = (params, args, tables)
    at_rest = _storages(rest)
    mt = MemTracker()
    mt.track_external(*_tensors(rest))
    t0 = time.perf_counter()
    with ops.abstract(), mt, count_costs(dev) as costs:
        out = run()
    trace_s = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak").get(dev, {}).get("Total", 0)
    outs = _storages(out)
    return {
        "costs": costs, "terms": analyze_costs(costs),
        "argument_bytes": sum(at_rest.values()),
        "output_bytes": sum(b for k, b in outs.items() if k not in at_rest),
        "alias_bytes": sum(b for k, b in outs.items() if k in at_rest),
        "peak_bytes": max(peak, sum(at_rest.values())),
        "trace_s": trace_s,
    }


_PLANS: dict = {}


def _lut_plans(cfg):
    """Shared-calibration serving plans of ``cfg`` (the reference's
    ``_lut_plan``: one table a site kind), compressed once a process."""
    from repro_torch.serve import build_serving_plans

    key = repr(cfg)
    if key not in _PLANS:
        calib = np.random.default_rng(0).normal(size=100000) * 3
        _PLANS[key] = build_serving_plans(cfg, calib, backend="cuda")
    return _PLANS[key]


def _lut_plan(cfg, mesh):
    """``(patched_cfg, lut_tables, placement_report)`` for a LUT-aware
    decode cell: the tables on the ``cuda`` backend on the meta device,
    and their placement priced a rank on this mesh
    (replicated tables cost full bytes on every rank, a layer-sharded
    slab its share and the buffer it is gathered into)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.sharded import plan_placement_report

    plans = _lut_plans(cfg)
    with ops.abstract():
        tables = plans.tables_for_model(backend="cuda", device="meta")
    return (plans.patched_config(cfg), tables,
            plan_placement_report(tables, mesh))


def dryrun_cell(arch: str, shape: str, multi_pod: bool,
                tcfg=None, quiet: bool = False,
                lut_act: bool = False, *, cfg=None, info=None,
                mesh_shape=None, kv_dtype: str = "bfloat16",
                lut_tables=None, tp_mode: str = "exact") -> dict:
    """One cell: ``arch`` at ``SHAPES[shape]`` on the production mesh
    (``multi_pod``: two pods, 512 ranks).  ``cfg``, ``info`` (``{"kind",
    "seq", "batch"}``) and ``mesh_shape`` (``(dp, tp)``) override the
    config, the shape and the mesh (the tests trace smoke configs on
    small meshes); ``lut_tables`` serves given tables (the hill climb's
    variants) instead of ``lut_act``'s plans; ``tp_mode`` the train
    step's, recorded in the JSON when ``"partitioned"``."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train import TrainConfig

    cfg = cfg or get_config(arch)
    info = info or SHAPES[shape]
    ok, why = cell_supported(cfg, shape, tp_mode)
    sizes = tuple(mesh_shape) if mesh_shape is not None else (
        (2, 16, 16) if multi_pod else (16, 16))
    result = {
        "arch": arch, "shape": shape, "mesh": "x".join(map(str, sizes)),
        "kind": info["kind"],
    }
    if tp_mode != "exact":
        result["tp_mode"] = tp_mode
    if not ok:
        result["status"] = "skipped"
        result["reason"] = why
        return result
    n_chips = math.prod(sizes)
    try:
        with fake_group(n_chips):
            mesh = (make_host_mesh(*sizes) if mesh_shape is not None
                    else make_production_mesh(multi_pod=multi_pod))
            if lut_act and info["kind"] == "decode" and lut_tables is None:
                cfg, lut_tables, report = _lut_plan(cfg, mesh)
                result["lut_tables"] = report
                if not quiet:
                    print(f"  lut tables: {report['replicated_bytes']} B "
                          f"replicated + {report['sharded_bytes']} B "
                          f"layer-sharded = {report['per_device_bytes']} B "
                          f"per device")
            if info["kind"] == "train" and tcfg is None:
                tcfg = TrainConfig(
                    microbatch=max(1, info["batch"] // _n_dp(mesh)),
                    remat=True)
            tr = trace_step(cfg, info["kind"], info["batch"], info["seq"],
                            mesh=mesh, tcfg=tcfg, lut_tables=lut_tables,
                            kv_dtype=kv_dtype, tp_mode=tp_mode)
        terms = tr["terms"]
        peak = tr["peak_bytes"]
        result.update({
            "status": "ok",
            "lower_s": round(tr["trace_s"], 2),
            "compile_s": 0.0,
            "memory": {
                "argument_size_in_bytes": tr["argument_bytes"],
                "output_size_in_bytes": tr["output_bytes"],
                "alias_size_in_bytes": tr["alias_bytes"],
                "temp_size_in_bytes": peak - tr["argument_bytes"],
                "generated_code_size_in_bytes": 0,
            },
            "roofline": terms.as_dict(),
            "model_flops": model_flops_per_step(
                cfg, info["batch"], info["seq"], info["kind"]),
            "n_chips": n_chips,
            "peak_bytes": peak,
            "fits_80gb": peak <= CARD_BYTES,
            "launches": dict(tr["costs"].launches),
            "n_ops": tr["costs"].n_ops,
        })
        if not quiet:
            print(f"  trace {tr['trace_s']:.1f}s "
                  f"dominant={terms.dominant} "
                  f"compute={terms.compute_s:.2e}s "
                  f"memory={terms.memory_s:.2e}s "
                  f"coll={terms.collective_s:.2e}s "
                  f"peak={peak / 1e9:.2f} GB"
                  + ("" if peak <= CARD_BYTES else " (over 80 GB)"))
    except Exception as e:  # noqa: BLE001 — report failures per cell
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["trace"] = traceback.format_exc()[-2000:]
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--lut-act", action="store_true",
                    help="decode cells serve shared-calibration LUT plans "
                         "and report per-device table bytes "
                         "(replicated vs layer-sharded)")
    ap.add_argument("--tp-mode", choices=("exact", "partitioned"),
                    default="exact",
                    help="the train step's mode (training cells; "
                         "partitioned: every family)")
    ap.add_argument("--out", default="experiments/torch/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or args.all)
              else [args.multi_pod])
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                if args.lut_act:
                    tag += "__lut"
                if args.tp_mode != "exact":
                    tag += "__part"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {tag}: {prev['status']}")
                        cells.append(prev)
                        continue
                print(f"[dryrun] {tag}", flush=True)
                res = dryrun_cell(arch, shape, mp, lut_act=args.lut_act,
                                  tp_mode=args.tp_mode)
                cells.append(res)
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                print(f"  -> {res['status']}"
                      + (f" ({res.get('error')})"
                         if res["status"] == "error" else "")
                      + f" (host max RSS {rss / 2**20:.2f} GiB)", flush=True)
    n_ok = sum(1 for c in cells if c["status"] == "ok")
    n_skip = sum(1 for c in cells if c["status"] == "skipped")
    n_err = len(cells) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(cells)} cells")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
