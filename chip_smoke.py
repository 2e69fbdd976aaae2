#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; nothing is caught):
  1. card, power limit, torch and CUDA versions;
  2. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. full-width ``qwen3-0.6b`` (28 layers, bf16, random weights from seed
     0): capture 2 calibration batches, compress per-(layer, site) tables,
     and a shared-table plan;
  4. every kernel against its plain PyTorch version on the card, at the
     serving path's shapes: K1/K2 bit for bit on bin edges +-1 ulp (bf16
     and f32, raw and packed slabs, a stack mixing w_lb == 0 and w_lb > 0);
     K3 bit for bit against its own GEMM followed by K1, and within 1% of
     ``torch.matmul`` followed by the plain LUT;
  5. the main path through the launcher's entry points, 4 requests x 64
     prompt tokens x 16 new tokens: (a) stacked + cuda, (b) unrolled +
     cuda, (c) shared tables + cuda, each token-identical to the gather
     backend on the same tables, and (d) stacked + cuda + --lut-fuse, with
     its agreement with (a); launch counts are zeroed before each form and
     read after it;
  6. per-kernel times (median CUDA-event time per launch over a run of
     launches after a warm-up; also with the host out of the loop, from a
     CUDA graph of the launches), the bound from bytes and operations, the
     plain versions' times, and for K3 the unfused library path (cuBLAS
     GEMM followed by K1) as ``library_ms``;
  7. one profiled decode step (exact, form (a), form (d)): wall time,
     kernels launched, device busy time and idle share.
The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Long logs go to ``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor-core
# and f32 CUDA-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

B, T, NEW = 4, 64, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def timed_ms(fn, n: int = 50, warmup: int = 5, reps: int = 5) -> float:
    """Median over ``reps`` of (CUDA-event time of ``n`` back-to-back calls)
    / n, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Device time per call with the host out of the loop: ``n`` calls
    captured in one CUDA graph, replayed, CUDA-event timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def bound(nbytes: float, flops: float, peak_flops: float):
    tb, tf = nbytes / PEAK_BYTES_S, flops / peak_flops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def edge_values(torch, dtype, dev, w_in=10, x_lo=-8.0, x_hi=8.0):
    """Every bin edge and grid point of the input quantizer, each with its
    neighbours one step of ``dtype`` below and above."""
    levels = (1 << w_in) - 1
    k = torch.arange(levels + 1, dtype=torch.float64, device=dev)
    grid = x_lo + torch.cat([k[:-1] + 0.5, k]) / levels * (x_hi - x_lo)
    t = grid.to(dtype)
    ib = torch.int32 if dtype == torch.float32 else torch.int16
    vals = torch.cat([(t.view(ib) + d).view(dtype) for d in (-1, 0, 1)])
    return vals[torch.isfinite(vals)]


def kernel_inputs(torch, rows, dtype, dev, gen):
    """(rows, 3072) inputs: the edge values first, N(0, 3) after."""
    n = rows * 3072
    x = (torch.randn(n, generator=gen, device=dev) * 3).to(dtype)
    e = edge_values(torch, dtype, dev)
    m = min(n, e.numel())
    x[:m] = e[:m]
    return x.view(rows, 3072)


def bits_equal(torch, a, b) -> bool:
    ib = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(ib), b.view(ib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__} — run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import build, launch_counts, ops
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain
    from repro_torch.kernels.lut_act import (
        lut_act_plain,
        lut_act_stacked_plain,
    )
    from repro_torch.launch import serve as launcher
    from repro_torch.nn.lut_act import build_lut_activation
    from repro_torch.serve import verify_backend_equivalence
    from repro_torch.serve.stacked import (
        StackedPlanArrays,
        multi_site_stacked_entry,
    )

    OUT_DIR.mkdir(exist_ok=True)
    # parity runs: no TF32, no reduced-precision bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    build.load()
    log(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f}s "
        f"(per source: "
        + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in built.items())
        + ")")
    ptxas = "\n".join(v["log"] for v in built.values())
    (OUT_DIR / "ptxas.log").write_text(ptxas)
    for line in ptxas.splitlines():
        if "Used" in line:
            log(f"    ptxas: {line.strip()}")

    # ---- 3. model, calibration, plans ------------------------------------
    common = ["--arch", "qwen3-0.6b", "--full", "--batch", str(B),
              "--prompt-len", str(T), "--new-tokens", str(NEW), "--lut-act",
              "--device", "cuda"]
    parse = launcher.parse_args
    # no --lut-backend: the launcher's default on the card, the kernels
    args_a = parse(common + ["--calib-steps", "2"])
    if args_a.lut_backend != "cuda":
        raise AssertionError(f"the launcher's default backend on the card "
                             f"is {args_a.lut_backend!r}, not 'cuda'")
    t0 = time.perf_counter()
    cfg0, params, batch, rng = launcher.setup(args_a)
    torch.cuda.synchronize()
    log(f"[3] {cfg0.name}: {cfg0.n_layers} layers, d_model {cfg0.d_model}, "
        f"d_ff {cfg0.d_ff}, vocab {cfg0.vocab_size}, {cfg0.dtype}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}G params "
        f"in {time.perf_counter() - t0:.1f}s")
    plans = launcher.build_plans(args_a, cfg0, params, rng,
                                 log=lambda m: log("    " + m))
    rep = plans.report
    log(f"    per-site plans: {plans.total_cost} P-LUTs, dedup_rate "
        f"{rep.dedup_rate:.3f}, {len(rep.plans)} tables")
    args_c = parse(common)
    # per-site capture leaves rng where the launcher's shared path reads it
    shared = launcher.build_plans(args_c, cfg0, params, rng,
                                  log=lambda m: log("    " + m))
    cfg = plans.patched_config(cfg0)

    # ---- 4. kernels against their plain versions on the card -------------
    gen = torch.Generator(device=dev).manual_seed(1)
    st_cuda = plans.tables_for_model(backend="cuda", device=dev)
    st_raw = plans.tables_for_model(backend="gather", device=dev)
    stacks = {"packed": st_cuda["sites"]["mlp"]["stacked"],
              "raw": st_raw["sites"]["mlp"]["stacked"]}
    # a stack whose layers mix w_lb == 0 and w_lb > 0 (the main path's
    # engine may pick w_lb == 0 everywhere)
    crng = np.random.default_rng(2)
    mixed = [build_lut_activation("silu", crng.normal(size=20000) * s,
                                  lb_candidates=lb)
             for s, lb in ((2, (0,)), (3, (2,)))]
    assert [m.plan.w_lb for m in mixed] == [0, 2]
    mst = StackedPlanArrays.from_entries(
        [{"meta": m.meta(), "arrays": m.plan_arrays(device="cpu").arrays}
         for m in mixed])
    stacks["mixed-packed"] = mst.entry(packed=True, device=dev)
    stacks["mixed-raw"] = mst.entry(packed=False, device=dev)
    checked = 0
    max_err = {"lut_act_stacked": 0.0, "lut_act": 0.0,
               "fused_matmul_lut": 0.0}

    def note_err(name, yk, yp):
        d = float((yk.float() - yp.float()).abs().max())
        max_err[name] = max(max_err[name], d)

    for rows in (B, B * T):
        for dtype in (torch.bfloat16, torch.float32):
            x = kernel_inputs(torch, rows, dtype, dev, gen)
            for name, st in stacks.items():
                for layer in range(st["meta"]["n_layers"]):
                    yk = ops.lut_act_stacked(x, st, layer)
                    yp = lut_act_stacked_plain(x, st, layer)
                    note_err("lut_act_stacked", yk, yp)
                    if not bits_equal(torch, yk, yp):
                        raise AssertionError(
                            f"K1 lut_act_stacked differs from its plain "
                            f"version: {name} layer {layer} rows {rows} "
                            f"{dtype} ({int((yk != yp).sum())} elements)")
                    checked += 1
            for name, lut in [("shared", shared.sites["mlp"].lut),
                              ("layer0", plans.sites["mlp"].luts[0]),
                              ("w_lb0", mixed[0]), ("w_lb2", mixed[1])]:
                for packed in (False, True):
                    pa = lut.plan_arrays(packed=packed, device=dev)
                    kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi, y_lo=lut.y_lo,
                              y_hi=lut.y_hi)
                    yk = ops.lut_act(x, pa, **kw)
                    yp = lut_act_plain(x, pa.arrays, l=pa.l, w_lb=pa.w_lb,
                                       w_hb=pa.w_hb, w_in=pa.w_in,
                                       w_out=pa.w_out, pack=pa.pack, **kw)
                    note_err("lut_act", yk, yp)
                    if not bits_equal(torch, yk, yp):
                        raise AssertionError(
                            f"K2 lut_act differs from its plain version: "
                            f"{name} packed={packed} rows {rows} {dtype}")
                    checked += 1
    torch.cuda.synchronize()
    log(f"[4] K1/K2 bit-exact against their plain versions on {checked} "
        f"(slab, layer, shape, dtype) cases")

    f_tables = plans.tables_for_model(backend="cuda", kernel="fused",
                                      device=dev)
    ftab = lambda layer: {"multi_entry": f_tables["multi"], "site": "mlp",
                          "layer": layer}
    f_slice = multi_site_stacked_entry(f_tables["multi"], "mlp")
    k3_mismatch = {}
    for m in (B, B * T):
        x = torch.randn(m, cfg.d_model, generator=gen, device=dev).to(
            torch.bfloat16)
        worst = 0.0
        for layer in (0, cfg.n_layers // 2, cfg.n_layers - 1):
            w = params.blocks["w_in"][layer]
            yk = ops.fused_matmul_lut(x, w, ftab(layer), gated=True)
            h = ops.fused_matmul_lut(x, w, ftab(layer), gated=True,
                                     epilogue=False)
            gate, up = h.chunk(2, dim=-1)
            yc = ops.lut_act_stacked(gate, f_slice, layer) * up
            if not bits_equal(torch, yk, yc):
                raise AssertionError(
                    f"K3 differs from its own GEMM followed by K1: M={m} "
                    f"layer {layer} ({int((yk != yc).sum())} elements)")
            yp = fused_matmul_lut_plain(x, w, ftab(layer), gated=True)
            note_err("fused_matmul_lut", yk, yp)
            frac = float((yk != yp).float().mean())
            worst = max(worst, frac)
        # the per-plan form (shared or unrolled tables under --lut-fuse):
        # scalars as kernel arguments, held against its GEMM + K2
        lut = shared.sites["mlp"].lut
        pa = lut.plan_arrays(packed=True, device=dev)
        ptab = {"meta": dict(lut.meta(), pack=pa.pack), "arrays": pa.arrays}
        w = params.blocks["w_in"][0]
        yk = ops.fused_matmul_lut(x, w, ptab, gated=True)
        gate, up = ops.fused_matmul_lut(x, w, ptab, gated=True,
                                        epilogue=False).chunk(2, dim=-1)
        yc = ops.lut_act(gate, pa, x_lo=lut.x_lo, x_hi=lut.x_hi,
                         y_lo=lut.y_lo, y_hi=lut.y_hi) * up
        if not bits_equal(torch, yk, yc):
            raise AssertionError(
                f"K3 (per-plan tables) differs from its own GEMM followed "
                f"by K2: M={m} ({int((yk != yc).sum())} elements)")
        k3_mismatch[m] = worst
        log(f"    K3 M={m}: bit-exact vs own GEMM + K1 (stacked) and + K2 "
            f"(per-plan); share differing "
            f"from torch.matmul + plain LUT: {worst:.6f}")
        if worst > 0.01:
            raise AssertionError(f"K3 differs from the plain path on "
                                 f"{worst:.4%} of outputs (limit 1%)")
    log("[4] K3 checks passed")

    # ---- 5. the main path -------------------------------------------------
    forms = {
        "a": (args_a, plans),
        "b": (parse(common + ["--calib-steps", "2", "--plan-exec",
                            "unrolled"]), plans),
        "c": (args_c, shared),
        "d": (parse(common + ["--calib-steps", "2", "--lut-fuse"]), plans),
    }
    uses = {"a": "lut_act_stacked", "b": "lut_act", "c": "lut_act",
            "d": "fused_matmul_lut"}
    results = {}
    totals = {k: 0 for k in launch_counts()}
    quiet = lambda m: None
    # the exact activation (no LUT) on the same weights, as a yardstick
    launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    exact = launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    log(f"[5] exact (no LUT): prefill {exact['prefill_s']:.4f}s, decode "
        f"{exact['decode_tok_s']:.1f} tok/s")
    for form, (args, pl) in forms.items():
        fcfg = dataclasses.replace(pl.patched_config(cfg0),
                                   lut_fuse=args.lut_fuse)
        tables = launcher.serving_tables(args, pl, dev, log=quiet)
        # warm-up run (first-launch costs), then the counted run
        launcher.serve(args, fcfg, params, batch, tables, log=quiet)
        reset_launch_counts()
        res = launcher.serve(args, fcfg, params, batch, tables, log=quiet)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            totals[k] += v
        if counts[uses[form]] == 0:
            raise AssertionError(f"form ({form}) launched no "
                                 f"{uses[form]} kernel: {counts}")
        line = (f"[5] ({form}) exec={args.plan_exec} fuse={args.lut_fuse} "
                f"calib={pl.calib}: prefill {res['prefill_s']:.4f}s, "
                f"decode {res['decode_tok_s']:.1f} tok/s; "
                f"{pl.total_cost} P-LUTs, dedup_rate "
                f"{pl.report.dedup_rate:.3f}, "
                f"{launcher.tables_nbytes(tables)} table bytes; "
                f"launches {counts}")
        if form != "d":
            g_args = parse(common + ["--lut-backend", "gather",
                                     "--plan-exec", args.plan_exec])
            g_tables = launcher.serving_tables(g_args, pl, dev, log=quiet)
            ref = launcher.serve(g_args, fcfg, params, batch, g_tables,
                                 log=quiet)
            if ref["tokens"] != res["tokens"]:
                raise AssertionError(
                    f"form ({form}) tokens differ from the gather backend: "
                    f"{res['tokens']} vs {ref['tokens']}")
            line += (f"; tokens == gather (gather: prefill "
                     f"{ref['prefill_s']:.4f}s, decode "
                     f"{ref['decode_tok_s']:.1f} tok/s)")
            res["gather"] = {k: ref[k] for k in ("prefill_s", "decode_s",
                                                 "decode_tok_s")}
        else:
            a = results["a"]["tokens"]
            agree = np.mean(np.array(a) == np.array(res["tokens"]))
            line += f"; token agreement with (a): {agree:.4f}"
            res["agreement_with_a"] = float(agree)
        log(line)
        log(f"    request 0: {res['tokens'][0]}")
        results[form] = res
    logits, _ = launcher.prefill(params, cfg, batch, max_seq=T + 1,
                                 lut_tables=st_cuda)
    if logits.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    # the port's own backend check (cuda == gather, token for token) on a
    # small input: the smoke config, per-layer tables, both exec forms
    s_args = parse(["--batch", "2", "--prompt-len", "8", "--new-tokens",
                    "4", "--lut-act", "--lut-backend", "cuda",
                    "--calib-steps", "1", "--device", "cuda"])
    s_cfg, s_params, s_batch, s_rng = launcher.setup(s_args)
    s_plans = launcher.build_plans(s_args, s_cfg, s_params, s_rng, log=quiet)
    for exec_ in ("stacked", "unrolled"):
        toks = verify_backend_equivalence(
            s_cfg, s_params, s_plans, s_batch["tokens"].cpu().numpy(), 4,
            plan_exec=exec_)
        log(f"[5] verify_backend_equivalence ({s_cfg.name}, {exec_}): "
            f"cuda == gather, request 0 {toks[0]}")

    # ---- 6. per-kernel times ---------------------------------------------
    L = cfg.n_layers
    st = stacks["packed"]
    slab_bytes = sum(int(st["arrays"][c][0].numel()) * 4
                     for c in st["arrays"])
    kernels = []
    for name, replaces, source in (
            ("lut_act_stacked", "src/repro/kernels/lut_act.py:174",
             "src/repro_torch/kernels/csrc/lut_act.cu"),
            ("lut_act", "src/repro/kernels/lut_act.py:82",
             "src/repro_torch/kernels/csrc/lut_act.cu")):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": totals[name],
                 "max_abs_err": max_err[name]}
        for shape_name, rows in (("decode", B), ("prefill", B * T)):
            x = kernel_inputs(torch, rows, torch.bfloat16, dev, gen)
            if name == "lut_act_stacked":
                kfn = lambda: ops.lut_act_stacked(x, st, L // 2)
                pfn = lambda: lut_act_stacked_plain(x, st, L // 2)
            else:
                lut = plans.sites["mlp"].luts[L // 2]
                pa = lut.plan_arrays(packed=True, device=dev)
                kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi, y_lo=lut.y_lo,
                          y_hi=lut.y_hi)
                kfn = lambda: ops.lut_act(x, pa, **kw)
                pfn = lambda: lut_act_plain(
                    x, pa.arrays, l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb,
                    w_in=pa.w_in, w_out=pa.w_out, pack=pa.pack, **kw)
            n = x.numel()
            bms, by = bound(2 * n * 2 + slab_bytes + 20, 5 * n,
                            PEAK_F32_FLOPS)
            t = {"ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
                 "plain_ms": timed_ms(pfn), "bound_ms": bms,
                 "bound_by": by}
            if shape_name == "decode":
                entry.update(t, library_ms=None, shape=[rows, 3072])
            else:
                entry["prefill"] = dict(t, shape=[rows, 3072])
        kernels.append(entry)

    entry = {"name": "fused_matmul_lut", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_matmul_lut.cu",
             "replaces": "src/repro/kernels/fused_matmul_lut.py:62",
             "launches": totals["fused_matmul_lut"],
             "max_abs_err": max_err["fused_matmul_lut"],
             "mismatch_share_vs_plain": k3_mismatch}
    K, N = cfg.d_model, 2 * cfg.d_ff
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        ws = [params.blocks["w_in"][i] for i in range(L)]   # 28 layers:
        it = iter(range(10 ** 9))                           # L2-cold weights
        kfn = lambda: ops.fused_matmul_lut(x, ws[next(it) % L],
                                           ftab(L // 2), gated=True)
        pfn = lambda: fused_matmul_lut_plain(x, ws[next(it) % L],
                                             ftab(L // 2), gated=True)
        mfn = lambda: torch.matmul(x, ws[next(it) % L])

        def lfn():
            # the unfused library yardstick: cuBLAS GEMM, then K1 and the
            # gated product (form (a)'s own path)
            gate, up = torch.matmul(x, ws[next(it) % L]).chunk(2, dim=-1)
            return ops.lut_act_stacked(gate, f_slice, L // 2) * up
        bms, by = bound(2 * (m * K + K * N + m * N // 2) + slab_bytes,
                        2 * m * K * N, PEAK_BF16_FLOPS)
        t = {"ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
             "plain_ms": timed_ms(pfn), "bound_ms": bms, "bound_by": by,
             "library_ms": timed_ms(lfn), "matmul_only_ms": timed_ms(mfn)}
        if shape_name == "decode":
            entry.update(t, shape=[m, K, N])
        else:
            entry["prefill"] = dict(t, shape=[m, K, N])
    kernels.append(entry)
    for k in kernels:
        log(f"[6] {k['name']}: {k['ms'] * 1e3:.2f} us/launch (graph "
            f"{k['graph_ms'] * 1e3:.2f} us) at {k['shape']}, bound "
            f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), plain "
            f"{k['plain_ms'] * 1e3:.2f} us; prefill {k['prefill']['ms'] * 1e3:.2f}"
            f" us (graph {k['prefill']['graph_ms'] * 1e3:.2f}), bound "
            f"{k['prefill']['bound_ms'] * 1e3:.3f} us, plain "
            f"{k['prefill']['plain_ms'] * 1e3:.2f} us; launches "
            f"{k['launches']}"
            + ("" if k["library_ms"] is None else
               f"; library {k['library_ms'] * 1e3:.2f} us, prefill "
               f"{k['prefill']['library_ms'] * 1e3:.2f} us"))
    # ---- 7. where a decode step's time goes --------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = {}
    for label, scfg, stab in (
            ("exact", cfg0, None), ("a", cfg, st_cuda),
            ("d", dataclasses.replace(cfg, lut_fuse=True), f_tables)):
        logits, cache = launcher.prefill(params, scfg, batch,
                                         max_seq=T + 2, lut_tables=stab)
        tok = logits[:, -1].argmax(-1)[:, None]
        launcher.decode_step(params, scfg, cache, tok, T, stab)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            launcher.decode_step(params, scfg, cache, tok, T + 1, stab)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kern)
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        steps[label] = {"wall_ms": wall * 1e3, "kernels": len(kern),
                        "device_busy_ms": busy_us / 1e3,
                        "idle_share": (1 - busy_us / 1e6 / wall) if kern
                        else None,
                        "top_kernels_us": top}
        log(f"[7] decode step ({label}): wall {wall * 1e3:.2f} ms, "
            f"{len(kern)} kernels, device busy {busy_us / 1e3:.2f} ms"
            + (f", idle share {steps[label]['idle_share']:.3f}" if kern
               else " (profiler saw no device events: idle not measured)"))
        for name, us in top[:5]:
            log(f"    {us:9.1f} us  {name[:90]}")
    (OUT_DIR / "profile.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))

    summary = {"card": smi, "exact": exact, "steps": steps, "forms": {
        f: {k: v for k, v in r.items() if k != "plans"}
        for f, r in results.items()}, "kernels": kernels}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
