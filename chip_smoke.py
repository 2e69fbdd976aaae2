#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py            # from the repository root, one card

Phases (any failure exits non-zero; nothing is caught):
  1. card, power limit, torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together); ``cuobjdump -sass`` on
     K3's library must show HGMMA (wgmma) and UTMALDG (TMA loads) in every
     bf16 kernel, and on K8's HMMA (its TF32 mma.sync);
  3. full-width ``qwen3-0.6b`` (28 layers, bf16, random weights from seed
     0): capture 2 calibration batches, compress per-(layer, site) tables
     for the MLP site, for every site (``--lut-sites all``) and for every
     site plus the logit softcap, and a shared-table plan;
  4. K1-K4 against their plain PyTorch versions on the card, at the
     serving path's shapes: K1/K2 bit for bit on bin edges +-1 ulp (bf16
     and f32, raw and packed slabs, a stack mixing w_lb == 0 and w_lb > 0);
     K3 bit for bit against its own GEMM followed by K1 (stacked tables) or
     K2 (per-plan tables), two launches bit-identical, and within 1% of
     ``torch.matmul`` followed by the plain LUT, at the serving shapes, at
     ragged M (1, 3, 5, 67, 257), F = 1000 and K = 1032, and on the f32
     route at one shape; K4 bit for bit against its
     plain version and, per site, against K1 on the all-sites super-slab
     (every layer, every site in one launch, f32 and bf16, a segment past
     its block cap), two launches bit-identical, single-site and
     all-sites calls replayed from a CUDA graph with eager's bits, and an
     entry without its launch record refused; K1/K2 again on
     the ``gate`` and ``up`` halves of a ``[gate|up]`` product (row stride
     2 x 3072, read in place: K1 there launches one kernel and no copy),
     a start 2 / 4 bytes past a 16-byte boundary and counts 1, 7 and
     8003, on every site's stack of the all-sites plans (every pack width
     their plans produce) and on per-layer plans;
  5. qwen3-0.6b served through the launcher's entry points, 4 requests x
     64 prompt tokens x 16 new tokens, decoding through the step captured
     in a CUDA graph: (a) stacked + cuda, (b) unrolled + cuda, (c) shared
     tables + cuda, (e) ``--lut-sites all`` stacked + cuda, (g)
     ``--lut-sites all --logit-softcap 30``, each token-identical to the
     gather backend on the same tables, and (d) ``--lut-fuse``, (f)
     ``--lut-sites all --lut-fuse`` (K3 + K4), (k) ``--kv-int8`` (the
     prompt replayed into an int8 cache), with their agreement with (a)
     and (e); launch counts are zeroed before each form and read after
     it; every form also decodes eagerly, with the captured run's tokens,
     and each replayed step's logits and the caches equal eager's bit for
     bit, with eager's launch counts;
  6. K5 (Eq. (1) at integer addresses) and K6 (plain lookup) bit for bit
     against their plain versions and ``plan.reconstruct()``: w_in 5-16,
     several M and w_lb, plain plans, odd query shapes, address counts of
     every residue mod 4, a view 4 bytes past a 16-byte alignment, tables
     under and over a block's shared-memory limit (neither kernel stages:
     a small table stays in L1, a large one does not);
  7. K7 (one LUT-NN layer) bit for bit against its plain version: ragged
     B x N x F x bits, the paper models' layer shapes, a case on each of
     ``k7_plan``'s routes (codes staged one byte each, staged as int32 at
     bits 9, unstaged where one row of codes does not fit a block's shared
     memory and where a row holds at most 16 codes), ragged last tiles;
     two launches and a CUDA-graph replay bit-identical on each route, and
     each launching its route's kernel (at the paper shapes the narrowed
     one, or the unstaged one where a row holds 16 codes);
  8. the paper's LUT-NN toolflow at full paper width through
     ``repro_torch.launch.lutnn``'s functions (train, extract, don't cares,
     CompressedLUT / ReducedLUT, reconstruction through K5/K6, accuracy
     through K7, Verilog): jsc-2l, the quickstart, then jsc-5l (100000 /
     20000 samples) and mnist (30000 / 5000), the reference benchmarks'
     paper scale; launch counts zeroed before each and read after it (K5
     / K6 once per plan, K7 once per chunk, layer and pass), every K7
     call's shape recorded;
  9. full-width ``rwkv6-3b`` (32 layers, bf16, random weights from seed
     0): plans for the ``ffn`` site and for every site; K3 non-gated at the
     ``ffn`` shape and around it (ragged M, N = 1000, K = 1032, per-plan
     tables) as in phase 4; K4 on
     its super-slab; K8 within ``rtol = atol = 1e-4`` of its plain version,
     finite and two launches bit-identical (layer 0's inputs of a real
     prefill, strong and weak decay, ``log_w = -e`` and ``-30`` on every
     step, ragged T, chunk 16, a given initial state);
  10. rwkv6-3b served in the same sizes, captured and eager as in
     phase 5: (x) exact (K8 only), (h)
     ``--lut-act`` stacked + cuda and (i) ``--lut-sites all``, each
     token-identical to gather, (j) ``--lut-sites all --lut-fuse`` (K3 + K4
     + K8) with its agreement with (i); each form must launch K8 once per
     layer of its prefill; and how far the LUT forms move the prefill
     logits, against the top-1 margin;
  11. per-kernel times (median CUDA-event time per launch over a run of
     launches after a warm-up; also with the host out of the loop, from a
     CUDA graph of the launches), the bound from bytes and operations, the
     plain versions' times, and the library yardstick where one PyTorch
     call computes the same function (K3: cuBLAS GEMM followed by K1, also
     from a CUDA graph; K6: ``torch.take``); K4 and K8 have none; K1 and K2
     on the served input (the ``gate`` view) and on a contiguous copy; K4
     at the shapes form (f) hands it in a prefill and a decode step,
     recorded from the served calls; K7 at the paper models' layer shapes
     and at every (layer, shape) the three toolflows handed it, on their
     own inputs, each held bit for bit against its plain version, beside
     its bound and beside the route ``k7_plan`` did not choose (timed
     too, and summed over the path's launches);
  12. one profiled decode step (qwen3-0.6b exact, forms (a), (d) and (f);
     rwkv6-3b exact and form (j)): wall time, kernels launched (copies
     among them: form (a) must launch as many as the exact step), device
     busy time, idle share and the wrappers' launches in the step; then
     the same step captured in a CUDA graph: one profiled replay (wall,
     kernels, busy, idle share, launch counts equal to eager's) and the
     CUDA-event time of a replay;
  13. (run after phase 5, so that its launches count on the main path)
     the continuous batcher, qwen3-0.6b at full width with form (a)'s
     tables, 4 slots, 8 requests of 16-64 prompt tokens and 16 new
     tokens, ``eos_token=-1``, bf16 and int8 caches, ``prefill="step"``
     and ``"replay"``: replay and step serve identical tokens, no request
     is dropped, every bf16 request's tokens equal its decode alone in
     the pool, one ``swap_tables`` to form (e)'s tables mid-run captures
     the step again and serves on; the replay prefill of 4 x 64 tokens,
     bf16 and int8, timed;
  14. (run after phase 13) artifacts through the launcher: ``--calib-path``
     saves the captured calibration, reloads it bit for bit and serves
     form (a)'s tokens from it; ``--save-plan`` then ``--tuned-plan`` serve
     forms (a) and (f) token-identically to the in-process plans;
  15. (run last, once the earlier models are freed) the moe family at
     full width, random weights from seed 0, bf16, the same 4 x 64 x 16:
     ``deepseek-moe-16b`` (28 layers, 64 routed experts top-6 at d_expert
     1408, 2 shared) in forms exact, (a) stacked + cuda (K1 twice a layer
     a step: ``expert`` and the shared experts' ``mlp``), (b) unrolled
     (K2), (d) ``--lut-fuse`` (K3 on the shared MLP, the expert site
     through K4), (f) ``--lut-sites all --lut-fuse`` (K3 + K4) and (k)
     ``--kv-int8``, then ``qwen3-moe-30b-a3b`` (48 layers, 128 experts
     top-8 at d_expert 768, no shared expert) exact and (a); each form
     captured and eager as in phase 5, (a) and (b) token-identical to the
     gather backend, every form launching the LUT kernels as often as its
     sites imply; every K1 / K2 / K4 call of a prefill and a decode step
     in forms (a), (b) and (f) held bit for bit against its plain version
     (K4 also against K1 per site) and timed from a CUDA graph beside its
     bound; K1 on the expert gate view launching one kernel and no copy;
     K4's copy of a strided expert input recorded; K3 at the shared-expert
     shape held against its own GEMM + K1 and timed beside cuBLAS + K1;
     the prefill's assignments dropped by capacity; parameter bytes, peak
     memory, and one eager and one captured decode step profiled per model
     (exact and (a)).
The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Long logs go to ``chiprun_out/`` (every
logged line to ``chiprun_out/chip_smoke.log``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 and TF32
# tensor-core and f32 CUDA-core FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12

B, T, NEW = 4, 64, 16


LOG = []   # the open chiprun_out/chip_smoke.log, once main() opens it


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG:
        f.write(msg + "\n")
        f.flush()


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def sig4(o):
    """``o`` (JSON-like) with every float rounded to 4 significant
    digits."""
    if isinstance(o, float):
        return float(f"{o:.4g}")
    if isinstance(o, dict):
        return {k: sig4(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [sig4(v) for v in o]
    return o


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


def bound(nbytes: float, flops: float, peak_flops: float, more=()):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over their peak.  ``more``: (operations,
    peak) of further units that run beside the first (tensor cores beside
    the CUDA cores); the operation time is the largest of them."""
    tb = nbytes / PEAK_BYTES_S
    tf = max([flops / peak_flops] + [o / p for o, p in more])
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def k8_work(c: int, n: int, sub: int = 16) -> tuple[int, int]:
    """(f32 CUDA-core operations, TF32 tensor-core operations) of K8 for
    one (batch, head) and one chunk of ``c`` steps at head size ``n``, as
    ``csrc/wkv.cu`` computes it: the cumsum and its shift (2 a value);
    diagonal sub-chunk blocks direct (a pair: sub, exp, two multiplies,
    add; the u bonus: two multiplies, add); off-diagonal blocks as the
    product of q and k pre-scaled from the anchor row (sub, exp, multiply
    a value, then 2 a multiply-add); the decay of q (exp, multiply) and
    of k (sub, exp, multiply); the state's decay (multiply, add); and on
    the tensor cores y's triangle ``a @ v``, ``q~ @ S`` and the update
    ``k~^T v``, each three TF32 products (3xTF32)."""
    lens = [min(sub, c - s) for s in range(0, c, sub)]
    f32 = 2 * c * n + 5 * c * n + 2 * n * n + n
    for i, li in enumerate(lens):
        f32 += li * (li - 1) // 2 * n * 5 + li * n * 3
        for lj in lens[:i]:
            f32 += (li + lj) * n * 3 + 2 * li * lj * n
    tc = 3 * (c * (c + 1) * n + 4 * c * n * n)
    return f32, tc


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
    ib = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ib), b.view(ib))


def k3_sass_counts(build, lib) -> dict:
    """``{kernel: {"HGMMA": n, "UTMALDG": n}}`` over K3's bf16 kernels in
    the built library's SASS (``cuobjdump`` from nvcc's ``bin``); raises
    unless every one of them holds both: the tensor-core route really runs
    wgmma fed by TMA."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "k3_tc_kernel" in name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name in counts:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    if not counts or not all(c["HGMMA"] and c["UTMALDG"]
                             for c in counts.values()):
        raise AssertionError(f"K3's bf16 kernels lack HGMMA or UTMALDG in "
                             f"their SASS: {counts}")
    # k3_tc_kernel<8> ... : the template argument is the token tile
    return {"tok" + n.split("kernelILi")[1].split("E")[0]: c
            for n, c in sorted(counts.items())}


def k1_layouts(torch, rows, dtype, dev, gen):
    """The inputs K1 / K2 meet, as ``{label: tensor}``: the ``gate`` and
    ``up`` halves of a ``(rows, 2 x 3072)`` ``[gate|up]`` product (row
    stride 6144, no copy), a flat view one element past a 16-byte
    boundary, and counts 1, 7 and 8k + 3; edge values first in each."""
    x = torch.cat([kernel_inputs(torch, rows, dtype, dev, gen),
                   kernel_inputs(torch, rows, dtype, dev, gen)], dim=-1)
    gate, up = x.chunk(2, dim=-1)
    flat = kernel_inputs(torch, 3, dtype, dev, gen).reshape(-1)
    out = {"gate view": gate, "up view": up, "misaligned": flat[1:8004]}
    for n in (1, 7, 8 * 1000 + 3):
        out[f"count {n}"] = flat[:n]
    if out["misaligned"].data_ptr() % 16 == 0 or gate.is_contiguous():
        raise AssertionError("the strided / misaligned K1 inputs are not")
    return out


def check_k1_layouts(dev, stacks, luts, gen) -> tuple[int, dict]:
    """K1 and K2 bit for bit against their plain versions on
    :func:`k1_layouts`' inputs, f32 and bf16, every layer of every stack
    in ``stacks`` (``{label: stacked entry}``) and every plan in ``luts``
    (``{label: LUTActivation}``) raw and packed.  Returns (cases, the pack
    widths covered per component)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_act import (
        lut_act_plain,
        lut_act_stacked_plain,
    )
    from repro_torch.kernels.packing import COMPONENTS

    widths = {c: set() for c in COMPONENTS}
    cases = 0
    for rows in (B, B * T):
        for dtype in (torch.bfloat16, torch.float32):
            for label, x in k1_layouts(torch, rows, dtype, dev, gen).items():
                if rows == B * T and label.startswith(("count", "mis")):
                    continue   # the same inputs as at rows = B
                for name, st in stacks.items():
                    for c, p in (st["meta"].get("pack") or {}).items():
                        widths[c].add(p["width"])
                    for layer in range(st["meta"]["n_layers"]):
                        yk = ops.lut_act_stacked(x, st, layer)
                        yp = lut_act_stacked_plain(x, st, layer)
                        if yk.shape != x.shape or not bits_equal(torch, yk,
                                                                 yp):
                            raise AssertionError(
                                f"K1 differs from its plain version on "
                                f"{label} {tuple(x.shape)}: {name} layer "
                                f"{layer} {dtype}")
                        cases += 1
                for name, lut in luts.items():
                    for packed in (False, True):
                        pa = lut.plan_arrays(packed=packed, device=dev)
                        for c, p in (pa.pack or {}).items():
                            widths[c].add(p["width"])
                        kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi,
                                  y_lo=lut.y_lo, y_hi=lut.y_hi)
                        yk = ops.lut_act(x, pa, **kw)
                        yp = lut_act_plain(
                            x, pa.arrays, l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb,
                            w_in=pa.w_in, w_out=pa.w_out, pack=pa.pack, **kw)
                        if yk.shape != x.shape or not bits_equal(torch, yk,
                                                                 yp):
                            raise AssertionError(
                                f"K2 differs from its plain version on "
                                f"{label} {tuple(x.shape)}: {name} "
                                f"packed={packed} {dtype}")
                        cases += 1
    torch.cuda.synchronize()
    return cases, {c: sorted(w) for c, w in widths.items()}


# the PyTorch ops that copy a tensor (what a wrapper runs to make a strided
# input contiguous)
COPY_OPS = ("aten.clone.default", "aten.copy_.default",
            "aten.contiguous.default")


def torch_ops_of(fn) -> list:
    """The PyTorch (aten) ops one call of ``fn`` runs, in order, seen by a
    dispatch mode: a launch wrapper runs its output's allocation and, where
    it copies its input first, that copy; its own kernel is a ``ctypes``
    call, no op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


def kernels_of(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches, in the order
    they ran, from the profiler (CPU and CUDA activity, as phase 12
    traces).  A first trace can miss the device's activity while CUPTI
    starts, so a trace that saw no device event at all is taken again, up
    to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # leave the tracer device memory
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if names:
            return names
    raise AssertionError("the profiler saw no device activity in three "
                         "traces")


def profile_decode_step(launcher, label, scfg, sparams, sbatch, stab,
                        tag="12") -> dict:
    """Where one decode step's time goes: one eager step profiled (wall,
    kernels, copies among them, device busy, idle share, the wrappers'
    launches), then the same step captured in a CUDA graph: one profiled
    replay (its launch counts must be eager's) and the CUDA-event time of
    a replay.  Writes ``chiprun_out/profile_<label>[_captured].txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import CapturedStep

    logits, cache = launcher.prefill(sparams, scfg, sbatch,
                                     max_seq=T + 2, lut_tables=stab)
    tok = logits[:, -1].argmax(-1)[:, None]
    launcher.decode_step(sparams, scfg, cache, tok, T, stab)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # leave the tracer device memory
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launcher.decode_step(sparams, scfg, cache, tok, T + 1, stab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_launches = {k: v for k, v in launch_counts().items() if v}
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    copies = sum("copy" in e.name for e in kern)
    out = {"wall_ms": wall * 1e3, "kernels": len(kern),
           "copy_kernels": copies, "device_busy_ms": busy_us / 1e3,
           "idle_share": (1 - busy_us / 1e6 / wall) if kern else None,
           "launches": step_launches, "top_kernels_us": top}
    log(f"[{tag}] decode step ({label}): wall {wall * 1e3:.2f} ms, "
        f"{len(kern)} kernels ({copies} copies), device busy "
        f"{busy_us / 1e3:.2f} ms"
        + (f", idle share {out['idle_share']:.3f}" if kern
           else " (profiler saw no device events: idle not measured)")
        + f"; launches {step_launches}")
    for name, us in top[:5]:
        log(f"    {us:9.1f} us  {name[:90]}")
    (OUT_DIR / f"profile_{label.replace(' ', '_')}.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total",
                                  row_limit=40))
    # the same step captured in a CUDA graph and replayed: one profiled
    # replay (wall, kernels, busy, idle share) and the device time per
    # replay from CUDA events over 20 replays
    step = CapturedStep(sparams, scfg, stab)
    step(cache, tok, T + 1)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(cache, tok, T + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    g_launches = {k: v for k, v in launch_counts().items() if v}
    if g_launches != step_launches:
        raise AssertionError(f"decode step ({label}): a replay counted "
                             f"{g_launches}, the eager step "
                             f"{step_launches}")
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    # the device's span of the replay: first kernel start to last end
    span_us = (max(e.time_range.end for e in kern)
               - min(e.time_range.start for e in kern)) if kern else 0
    replay_ms = timed_ms(lambda: step(cache, tok, T + 1), n=20,
                         warmup=2, reps=3)
    out["captured"] = {
        "wall_ms": wall * 1e3, "kernels": len(kern),
        "device_busy_ms": busy_us / 1e3,
        "idle_share": (1 - busy_us / 1e6 / wall) if kern else None,
        "device_span_ms": span_us / 1e3,
        "span_idle_share": (1 - busy_us / span_us) if kern else None,
        "replay_ms": replay_ms, "capture_s": step.capture_s}
    c = out["captured"]
    log(f"[{tag}] captured step ({label}): wall {c['wall_ms']:.2f} ms, "
        f"{len(kern)} kernels, device busy {busy_us / 1e3:.2f} ms"
        + (f", idle share {c['idle_share']:.3f}; the device's span "
           f"{span_us / 1e3:.2f} ms, idle {c['span_idle_share']:.3f} "
           f"of it" if kern else
           " (profiler saw no device events: idle not measured)")
        + f"; {replay_ms:.3f} ms a replay back to back (CUDA events)"
        + f"; capture {step.capture_s:.3f}s; launches as eager")
    (OUT_DIR / f"profile_{label.replace(' ', '_')}_captured.txt"
     ).write_text(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=40))
    del step
    return out


def k8_hmma_count(build, lib) -> int:
    """HMMA instructions (tensor-core mma.sync) in K8's kernel, from the
    built library's SASS; raises if there are none: y and the state update
    really run on the tensor cores."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    n, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "wkv_kernel" in line
        elif inside:
            n += "HMMA" in line
    if n == 0:
        raise AssertionError("K8's kernel has no HMMA in its SASS")
    return n


# -------------------------------------------------------------------------
# the LUT-NN toolflow's kernels: K5 / K6 (lut_gather.cu), K7 (lutnn_layer.cu)
# -------------------------------------------------------------------------
# (w_in, w_out, w_lb, M) of decomposed plans built directly from a
# decomposition: the golden tests' geometries, w_in 8-14, and w_in 16 with a
# low-bit table of 2^16 entries (256 KB: read from device memory)
GATHER_DECOMPOSED = [(5, 4, 0, 4), (5, 6, 2, 8), (6, 5, 1, 8), (9, 8, 3, 16),
                     (8, 4, 0, 8), (10, 6, 1, 16), (12, 8, 2, 32),
                     (14, 7, 1, 64), (16, 8, 1, 64)]
GATHER_PLAIN = [(5, 3), (7, 6), (12, 8), (16, 8)]   # (w_in, w_out)
# (B, P, N, F, bits) of the paper models' LUT-NN layers
LUTNN_SHAPES = {"jsc-2l L0": (3000, 16, 32, 3, 4),
                "jsc-2l L1": (3000, 32, 5, 3, 4),
                "jsc-5l L0": (20000, 16, 128, 2, 7),
                "mnist L0": (5000, 784, 256, 6, 2)}
# the route k7_plan takes at each: unstaged where a row holds 16 codes
LUTNN_ROUTES = {"jsc-2l L0": "unstaged", "jsc-2l L1": "narrow",
                "jsc-5l L0": "unstaged", "mnist L0": "narrow"}
# 32-bit integer ALU work is counted at the f32 CUDA-core peak: an H100 SM
# issues int32 no faster than f32, so the operation bound stays a lower
# bound on the time
PEAK_INT32_OPS = PEAK_F32_FLOPS


def max_abs_diff(a, b) -> int:
    if a.shape != b.shape:
        return -1
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def decomposed_plan(w_in, w_out, w_lb, m, seed):
    """A decomposed plan of a smooth random table (no plain fallback)."""
    from repro_torch.core import TableSpec
    from repro_torch.core.pipeline import pack_decomposition
    from repro_torch.core.similarity import make_decomposition

    spec = TableSpec.random(w_in, w_out, 0.3, seed, smooth=True)
    hb = spec.values >> w_lb
    lb = (spec.values & ((1 << w_lb) - 1)) if w_lb else None
    d = make_decomposition(hb, spec.care_mask(), m)
    return pack_decomposition(d, w_in=w_in, w_hb=w_out - w_lb, w_lb=w_lb,
                              lb_values=lb, name="g")


def gather_plain(x, pa):
    """The plain version of K5 or K6 for ``pa``'s kind."""
    from repro_torch.kernels.lut_gather import (
        COMPONENTS,
        lut_reconstruct_plain,
        plain_lookup_plain,
    )

    if pa.kind == "plain":
        return plain_lookup_plain(x, pa.arrays["table"])
    return lut_reconstruct_plain(x, *(pa.arrays[c] for c in COMPONENTS),
                                 l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb)


def table_bytes(pa) -> int:
    """Bytes of the tables K5 / K6 stage for ``pa`` (t_lb only when read)."""
    if pa.kind == "plain":
        return pa.arrays["table"].numel() * 4
    return 4 * sum(t.numel() for c, t in pa.arrays.items()
                   if c != "t_lb" or pa.w_lb > 0)


def check_gather_kernels(dev) -> dict:
    """K5 and K6 bit for bit against their plain versions (and the plan's
    own reconstruction), each on tables under and over a block's
    shared-memory limit (neither stages them, but a small table stays in
    L1 and a large one does not), on address counts of every residue mod 4
    and on a view whose data pointer is 4 but not 16 bytes aligned (the
    scalar path).  Returns each kernel's largest difference from its plain
    version."""
    import numpy as np
    import torch

    from repro_torch.core import PlainPlan, TableSpec
    from repro_torch.kernels import PlanArrays, lut_reconstruct

    limit = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin
    plans = [decomposed_plan(*g, seed=sum(g)) for g in GATHER_DECOMPOSED]
    plans += [PlainPlan(TableSpec.random(w, o, 0.0, 2).values, w, o)
              for w, o in GATHER_PLAIN]
    rng = np.random.default_rng(3)
    covered = {"decomposed": set(), "plain": set()}
    errors = {"lut_reconstruct": 0, "plain_lookup": 0}
    cases = 0
    for plan in plans:
        pa = PlanArrays.from_plan(plan, device=dev)
        name = "plain_lookup" if pa.kind == "plain" else "lut_reconstruct"
        nbytes = table_bytes(pa)
        covered[pa.kind].add("under" if nbytes <= limit else "over")
        size = 1 << plan.w_in
        full = torch.arange(size, dtype=torch.int32, device=dev)
        addr = lambda *s: torch.as_tensor(rng.integers(0, size, s),
                                          dtype=torch.int32, device=dev)
        view = addr(4100)[1:]   # 4099 addresses, 4 bytes past an alignment
        if view.data_ptr() % 16 != 4:
            raise AssertionError("the misaligned view is aligned")
        queries = [full, view] + [addr(*s) for s in (
            (), (1,), (1000,), (3, 37), (1 << 20,), (4097,), (4098,),
            (4099,))]
        for x in queries:
            yk = lut_reconstruct(x, pa)
            yp = gather_plain(x, pa)
            errors[name] = max(errors[name], max_abs_diff(yk, yp))
            if yk.shape != x.shape or not torch.equal(yk, yp):
                raise AssertionError(
                    f"{pa.kind} plan w_in {plan.w_in} ({nbytes} table "
                    f"bytes): kernel differs from its plain version on "
                    f"query shape {tuple(x.shape)} (data pointer mod 16: "
                    f"{x.data_ptr() % 16})")
            cases += 1
        if not np.array_equal(lut_reconstruct(full, pa).cpu().numpy(),
                              plan.reconstruct()):
            raise AssertionError(f"{pa.kind} plan w_in {plan.w_in}: kernel "
                                 f"differs from plan.reconstruct()")
    torch.cuda.synchronize()
    # neither kernel stages its tables, but each is held on tables of
    # either size
    for kind, seen in covered.items():
        if seen != {"under", "over"}:
            raise AssertionError(f"{kind} plans covered only tables {seen} "
                                 f"the {limit}-byte limit")
    log(f"[6] K5/K6 bit-exact against their plain versions and "
        f"plan.reconstruct() on {cases} (plan, query) cases: tables under "
        f"and over a block's {limit}-byte shared-memory limit, address "
        f"counts 4k+1, 4k+2, 4k+3 and a view 4 bytes past a 16-byte "
        f"alignment")
    return errors


def lutnn_inputs(dev, rng, b, p, n, f, bits):
    """Random in-range (codes, conn, tables) int32 tensors on ``dev``."""
    import torch

    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return (as_t(rng.integers(0, 1 << bits, (b, p))),
            as_t(rng.integers(0, p, (n, f))),
            as_t(rng.integers(0, 1 << bits, (n, 1 << (bits * f)))))


# the kernel each K7 route launches, as the profiler names it
K7_KERNELS = {"narrow": "lutnn_tile_kernel<unsigned char>",
              "int32": "lutnn_tile_kernel<unsigned int>",
              "unstaged": "lutnn_unstaged_kernel"}


def k7_route(dev, b, p, n, f, bits):
    """K7's plan for a shape on ``dev`` (kernels/lutnn_layer.py)."""
    from repro_torch.kernels.lut_act import sm_count
    from repro_torch.kernels.lutnn_layer import k7_plan, smem_optin

    return k7_plan(b, p, n, f, bits, 1 << (bits * f), sm_count=sm_count(dev),
                   smem_limit=smem_optin(dev))


def check_lutnn_layer(dev) -> int:
    """K7 bit for bit against its plain version: a sweep of ragged sizes,
    the paper models' layer shapes, a case on each route (codes staged one
    byte each, staged as int32 at bits 9, unstaged where one row of codes
    does not fit a block's shared memory and where a row holds at most 16
    codes), row counts that leave a ragged last tile on every staged
    route, a tile past the 48 KB a block takes without opting in, two
    launches bit-identical and a CUDA-graph replay equal to eager on each
    route, and the profiler's kernel names: at the paper shapes the kernel
    of the route ``LUTNN_ROUTES`` names, each route's own kernel on its
    case.  Returns the largest difference from the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import lutnn_layer
    from repro_torch.kernels.lutnn_layer import lutnn_layer_plain, smem_optin

    rng = np.random.default_rng(4)
    shapes = [(b, 50, n, f, bits) for b in (1, 7, 300) for n in (1, 13, 40)
              for f in range(2, 7) for bits in range(1, 8)
              if bits * f <= 14]
    shapes += list(LUTNN_SHAPES.values())
    # one row of codes past what a block can stage beside the wiring
    p_over = smem_optin(dev) + 1
    routes = {"narrow": (5000, 784, 256, 6, 2),
              "int32": (301, 50, 13, 2, 9),
              "unstaged": (5, p_over, 40, 3, 4)}
    ragged = [(b + 1, p, n, f, bits)
              for b, p, n, f, bits in LUTNN_SHAPES.values()]
    # a tile of three rows of 60000 codes: past the 48 KB a block takes
    # without opting in
    big = (500, 60000, 40, 3, 4)
    if k7_route(dev, *big).smem <= 48 * 1024:
        raise AssertionError(f"K7 at {big} stays under 48 KB")
    ragged += [(1697, 16, 128, 2, 7), (4099, 50, 40, 2, 9), big]
    shapes += list(routes.values()) + ragged
    err = 0
    seen = {}
    for b, p, n, f, bits in shapes:
        plan = k7_route(dev, b, p, n, f, bits)
        codes, conn, tables = lutnn_inputs(dev, rng, b, p, n, f, bits)
        yk = lutnn_layer(codes, conn, tables, bits=bits)
        yp = lutnn_layer_plain(codes, conn, tables, bits=bits)
        err = max(err, max_abs_diff(yk, yp))
        if yk.shape != (b, n) or not torch.equal(yk, yp):
            raise AssertionError(
                f"K7 differs from its plain version at B {b}, P {p}, N {n}, "
                f"F {f}, bits {bits} ({plan})")
        if plan.route != "unstaged" and b % plan.rows:
            seen.setdefault(plan.route, []).append((b, plan.rows))
    if set(seen) != {"narrow", "int32"}:
        raise AssertionError(f"ragged last tiles seen only on {seen}")
    repeat = dict(LUTNN_SHAPES, int32=routes["int32"],
                  unstaged=routes["unstaged"], **{"past 48 KB": big})
    fns, want = {}, {}
    for label, (b, p, n, f, bits) in repeat.items():
        want[label] = LUTNN_ROUTES.get(
            label, label if label in routes else "narrow")
        route = k7_route(dev, b, p, n, f, bits).route
        if route != want[label]:
            raise AssertionError(f"K7 at {label} {(b, p, n, f, bits)} "
                                 f"plans the {route} route, not "
                                 f"{want[label]}")
        codes, conn, tables = lutnn_inputs(dev, rng, b, p, n, f, bits)
        fns[label] = functools.partial(lutnn_layer, codes, conn, tables,
                                       bits=bits)
    names = {}
    for label, fn in fns.items():
        # 16 launches a trace: the profiler can miss the first launches
        # of a trace while CUPTI starts
        seen_names = set(kernels_of(lambda: [fn() for _ in range(16)]))
        names[label] = seen_names.pop()
        if seen_names or K7_KERNELS[want[label]] not in names[label]:
            raise AssertionError(f"K7 at {label} launched {names[label]} "
                                 f"and {seen_names}, not its "
                                 f"{want[label]} kernel")
        y1, y2 = fn(), fn()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            yg = fn()
        yg.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(y1, yg)):
            raise AssertionError(f"K7 at {label} {repeat[label]}: two "
                                 f"launches or a graph replay differ")
    torch.cuda.synchronize()
    log(f"[7] K7 bit-exact against its plain version on {len(shapes)} "
        f"shapes (B 1/7/300 x N 1/13/40 x F 2-6 x bits 1-7 with "
        f"bits*F <= 14, {', '.join(LUTNN_SHAPES)}, each route: "
        + ", ".join(f"{r} {s}" for r, s in routes.items())
        + f"; ragged last tiles (B, rows per tile): {seen}); two launches "
        f"and a graph replay bit-identical, and each launches its route's "
        f"kernel: " + ", ".join(f"{k} {v[:48]}" for k, v in names.items()))
    return err


# the toolflows of phase 8: paper width (model.py::paper_model), jsc-2l at
# the launcher's data sizes, jsc-5l and mnist at the reference benchmarks'
# "paper" scale (benchmarks/common.py); every run 12 epochs
TOOLFLOWS = {"jsc-2l": [],
             "jsc-5l": ["--n-train", "100000", "--n-test", "20000"],
             "mnist": ["--n-train", "30000", "--n-test", "5000"]}


def run_lutnn(dev, model: str, extra: list) -> dict:
    """One toolflow through ``repro_torch.launch.lutnn.run`` on the card,
    launch counts zeroed before it and read after it: K5 / K6 once per
    decomposed / plain plan, K7 once per chunk, layer and table-network
    pass (the don't-care marking on the training set, then test and
    training accuracy before and after).  Records every K7 call's (B, P,
    N, F, bits) by layer, with the first such call's inputs and the number
    of such calls, as ``"k7_calls"``: ``{(layer, shape): ((codes, conn,
    tables), calls)}``."""
    import torch

    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch import lutnn
    from repro_torch.lutnn.inference import CHUNK

    argv = ["--model", model, *extra]
    if model == "jsc-2l":
        argv += ["--verilog-out", str(OUT_DIR / "jsc2l_reducedlut.v")]
    args = lutnn.parse_args(argv)
    calls, layers = {}, {}
    orig = ops.lutnn_layer_cuda

    def spy(codes, conn, tables, *, bits):
        # every pass hands a layer the same wiring tensor, and the first
        # chunk of the first pass meets the layers in order
        layer = layers.setdefault(conn.data_ptr(), len(layers))
        shape = (*codes.shape, *conn.shape, bits)
        inputs, seen = calls.get((layer, shape), ((codes, conn, tables), 0))
        calls[layer, shape] = (inputs, seen + 1)
        return orig(codes, conn, tables, bits=bits)

    ops.lutnn_layer_cuda = spy
    reset_launch_counts()
    try:
        out = lutnn.run(args, log=lambda m: log("    " + m))
        torch.cuda.synchronize()
    finally:
        ops.lutnn_layer_cuda = orig
    counts = launch_counts()
    if not out["device"].startswith("cuda"):
        raise AssertionError(f"the toolflow ran on {out['device']}")
    chunks = {k: -(-v // CHUNK) for k, v in out["samples"].items()}
    want = {"lut_reconstruct": out["plans"]["decomposed"],
            "plain_lookup": out["plans"]["plain"],
            "lutnn_layer": out["layers"] * (3 * chunks["train"]
                                            + 2 * chunks["test"])}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{model}: {name} launched {counts[name]} "
                                 f"times, not {n}: {counts}")
    if counts["lut_reconstruct"] == 0:
        raise AssertionError(f"{model}: the toolflow did not launch K5: "
                             f"{counts}")
    if sum(c for _, c in calls.values()) != counts["lutnn_layer"]:
        raise AssertionError(f"{model}: {counts['lutnn_layer']} K7 launches"
                             f" counted, {calls.values()} recorded")
    acc, pl = out["accuracy"], out["pluts"]
    log(f"[8] toolflow {out['model']} on {out['device']} ({out['samples']} "
        f"samples, {args.epochs} epochs): P-LUTs baseline "
        f"{pl['baseline']}, CompressedLUT {pl['compressedlut']}, "
        f"ReducedLUT {pl['reducedlut']}; train acc {acc['train_before']:.4f}"
        f" -> {acc['train_after']:.4f} (equal), test acc "
        f"{acc['test_before']:.4f} -> {acc['test_after']:.4f}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items())
        + f"; launches {counts}; K7 (layer, (B, P, N, F, bits)): calls "
        + ", ".join(f"{k} {c}" for k, (_, c) in sorted(calls.items())))
    out["launches"] = counts
    out["k7_calls"] = calls
    return out


def run_toolflow(dev) -> dict:
    """The paper's LUT-NN toolflow at full paper width through the
    launcher's functions: jsc-2l, the quickstart, then jsc-5l and mnist
    at the reference's paper data scale; launch counts zeroed before each
    and read after it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import quickstart

    flows = {"jsc-2l": run_lutnn(dev, "jsc-2l", TOOLFLOWS["jsc-2l"])}
    reset_launch_counts()
    q = quickstart.run(log=lambda m: log("    " + m))
    torch.cuda.synchronize()
    qcounts = launch_counts()
    if qcounts["lut_reconstruct"] + qcounts["plain_lookup"] != 4 or \
            qcounts["plain_lookup"] == 0:
        raise AssertionError(f"the quickstart launched {qcounts} for its "
                             f"four plans (one plain)")
    log(f"[8] quickstart: CompressedLUT {q['compressedlut']}, ReducedLUT "
        f"{q['reducedlut_20']} / {q['reducedlut_250']} P-LUTs (ex 20 / 250),"
        f" care-exact {q['care_exact']}; launches {qcounts}")
    for model in ("jsc-5l", "mnist"):
        flows[model] = run_lutnn(dev, model, TOOLFLOWS[model])
    # the slice's main path: every entry point
    return {"flows": flows, "quickstart": dict(q, launches=qcounts),
            "main_launches": {
                k: qcounts[k] + sum(f["launches"][k] for f in flows.values())
                for k in qcounts}}


def n_unique(t) -> int:
    import torch

    return int(torch.unique(t).numel())


def gather_work(pa, x):
    """(bytes, ops) K5 / K6 needs for addresses ``x``: each address read
    and each output written once, and each table entry these addresses
    touch read once."""
    import torch

    n = x.numel()
    if pa.kind == "plain":
        return 4 * (2 * n + n_unique(x)), n
    xl = x.long()
    hb = xl >> pa.l
    idx = pa.arrays["t_idx"][hb].long()
    touched = 3 * n_unique(hb) + n_unique(idx * (1 << pa.l)
                                          + (xl & ((1 << pa.l) - 1)))
    if pa.w_lb > 0:
        touched += n_unique(xl)
    return 4 * (2 * n + touched), 12 * n


def lutnn_work(codes, conn, tables, bits):
    """(bytes, ops) K7 needs: the code columns the wiring reads, the
    wiring, the table entries the addresses touch, and the output."""
    import torch

    from repro_torch.kernels.lutnn_layer import pack_addresses

    b = codes.shape[0]
    n, f = conn.shape
    rows = torch.arange(n, device=codes.device)
    touched = n_unique(rows * tables.shape[1]
                       + pack_addresses(codes, conn, bits))
    nbytes = 4 * (b * n_unique(conn) + n * f + touched + b * n)
    return nbytes, b * n * (3 * f + 2)


def k7_other_route(dev, codes, conn, tables, bits):
    """``(plan, launch)`` of K7 on the route ``k7_plan`` does not take
    for this shape (staged where it plans unstaged, where a row fits;
    else unstaged), through ``lutnn_layer_cuda`` with that plan; ``(None,
    None)`` where no other route fits.  The yardstick of the plan's
    choice in the same run; not a wrapper launch, so it is not counted."""
    from repro_torch.kernels.lut_act import sm_count
    from repro_torch.kernels.lutnn_layer import (
        k7_staged_plan,
        k7_unstaged_plan,
        lutnn_layer_cuda,
        smem_optin,
    )

    b, p = codes.shape
    n, f = conn.shape
    if k7_route(dev, b, p, n, f, bits).route != "unstaged":
        plan = k7_unstaged_plan(b)
    else:
        plan = k7_staged_plan(b, p, n, f, bits, sm_count=sm_count(dev),
                              smem_limit=smem_optin(dev))
    if plan is None:
        return None, None
    return plan, functools.partial(lutnn_layer_cuda, codes, conn, tables,
                                   bits=bits, plan=plan)


def time_toolflow_kernels(dev, flow, errors) -> list:
    """Per-kernel times of K5, K6 and K7 at the toolflow's shapes."""
    import numpy as np
    import torch

    from repro_torch.core import PlainPlan
    from repro_torch.kernels import PlanArrays, lut_reconstruct, lutnn_layer
    from repro_torch.kernels.lutnn_layer import lutnn_layer_plain

    plan = next(p for p in flow["flows"]["jsc-2l"]["plan_list"]
                if p.kind == "decomposed")
    plain = PlainPlan(plan.reconstruct(), plan.w_in, plan.w_out)
    rng = np.random.default_rng(5)
    size = 1 << plan.w_in
    queries = {"one table": torch.arange(size, dtype=torch.int32,
                                         device=dev),
               "2^20 addresses": torch.as_tensor(
                   rng.integers(0, size, 1 << 20), dtype=torch.int32,
                   device=dev)}
    kernels = []
    for name, p, line in (("lut_reconstruct", plan, 43),
                          ("plain_lookup", plain, 83)):
        pa = PlanArrays.from_plan(p, device=dev)
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/lut_gather.cu",
                 "replaces": f"src/repro/kernels/lut_gather.py:{line}",
                 "launches": flow["main_launches"][name],
                 "max_abs_err": errors[name], "shapes": {}}
        for label, x in queries.items():
            nbytes, ops_ = gather_work(pa, x)
            bms, by = bound(nbytes, ops_, PEAK_INT32_OPS)
            t = {"shape": list(x.shape),
                 "ms": timed_ms(lambda: lut_reconstruct(x, pa)),
                 "graph_ms": graph_ms(lambda: lut_reconstruct(x, pa)),
                 "plain_ms": timed_ms(lambda: gather_plain(x, pa)),
                 "bound_ms": bms, "bound_by": by, "library_ms": None}
            if name == "plain_lookup":
                # torch.take indexes with int64 addresses
                table, xl = pa.arrays["table"], x.long()
                t["library_ms"] = timed_ms(lambda: torch.take(table, xl))
                t["library_graph_ms"] = graph_ms(
                    lambda: torch.take(table, xl))
            if not entry["shapes"]:
                entry.update({k: v for k, v in t.items()})
            entry["shapes"][label] = t
        kernels.append(entry)

    entry = {"name": "lutnn_layer", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lutnn_layer.cu",
             "replaces": "src/repro/kernels/lutnn_layer.py:40",
             "launches": flow["main_launches"]["lutnn_layer"],
             "max_abs_err": errors["lutnn_layer"], "shapes": {}}
    # the paper models' layer shapes on random in-range codes, then every
    # (layer, shape) the three toolflows handed K7, on their own inputs;
    # each held bit for bit against the plain version and against the
    # other route, which is timed beside it
    cases = {label: (lutnn_inputs(dev, rng, *shape), shape[-1], 50, 0)
             for label, shape in LUTNN_SHAPES.items()}
    for model, fl in flow["flows"].items():
        for (layer, shape), (inputs, calls) in sorted(
                fl["k7_calls"].items()):
            cases[f"{model} toolflow L{layer} B {shape[0]}"] = (
                inputs, shape[-1], 10, calls)
    path = {"calls": 0, "plan_ms": 0.0, "other_ms": 0.0}
    for label, ((codes, conn, tables), bits, n_plain, calls) in \
            cases.items():
        shape = [*codes.shape, *conn.shape, bits]
        kfn = lambda: lutnn_layer(codes, conn, tables, bits=bits)
        want = lutnn_layer_plain(codes, conn, tables, bits=bits)
        other, ofn = k7_other_route(dev, codes, conn, tables, bits)
        if not torch.equal(kfn(), want) or (
                ofn is not None and not torch.equal(ofn(), want)):
            raise AssertionError(f"K7 differs from its plain version at "
                                 f"{label} {shape}")
        nbytes, ops_ = lutnn_work(codes, conn, tables, bits)
        bms, by = bound(nbytes, ops_, PEAK_INT32_OPS)
        t = {"shape": shape, "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
             "plain_ms": timed_ms(lambda: lutnn_layer_plain(
                 codes, conn, tables, bits=bits), n=n_plain),
             "bound_ms": bms, "bound_by": by, "library_ms": None,
             "plan": list(k7_route(dev, *shape)), "calls": calls,
             "other_plan": None if other is None else list(other),
             "other_graph_ms": None if ofn is None else graph_ms(ofn)}
        if calls and ofn is not None:
            path["calls"] += calls
            path["plan_ms"] += calls * t["graph_ms"]
            path["other_ms"] += calls * t["other_graph_ms"]
        if not entry["shapes"]:
            entry.update(t)
        entry["shapes"][label] = t
    recorded = sum(1 for t in entry["shapes"].values() if t["calls"])
    if path["calls"] != flow["main_launches"]["lutnn_layer"]:
        raise AssertionError(f"K7's recorded calls {path} are not the "
                             f"path's {flow['main_launches']['lutnn_layer']}"
                             f" launches")
    entry["path"] = path
    log(f"[11] K7 bit-exact against its plain version and its other route "
        f"at {len(cases)} shapes, {recorded} of them the (layer, shape) "
        f"cases the toolflows recorded; over the path's {path['calls']} "
        f"launches, from a graph: the plan's routes "
        f"{path['plan_ms'] * 1e3:.2f} us, the other routes "
        f"{path['other_ms'] * 1e3:.2f} us")
    kernels.append(entry)
    for k in kernels:
        for label, t in k["shapes"].items():
            log(f"[11] {k['name']} {label} {t['shape']}: {t['ms'] * 1e3:.2f} "
                f"us/launch (graph {t['graph_ms'] * 1e3:.2f} us), bound "
                f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
                f"{t['plain_ms'] * 1e3:.2f} us"
                + ("" if t["library_ms"] is None else
                   f", library {t['library_ms'] * 1e3:.2f} us (graph "
                   f"{t['library_graph_ms'] * 1e3:.2f} us)")
                + (f"; plan {t['plan']}" if "plan" in t else "")
                + (f"; other route {t['other_plan']} "
                   f"{t['other_graph_ms'] * 1e3:.2f} us (graph); "
                   f"{t['calls']} calls on the path"
                   if t.get("other_graph_ms") is not None else "")
                + f"; launches {k['launches']} (toolflows + quickstart)")
    return kernels


# -------------------------------------------------------------------------
# the multi-site kernel K4 (lut_act_multi.cu) and the WKV kernel K8 (wkv.cu)
# -------------------------------------------------------------------------
# K4 segment lengths: one per per-layer site, different, one not a multiple
# of a block's elements, one past the per-segment block cap in both dtypes
# (a full card of resident threads at 16 bytes a thread: the kernel strides;
# kernels/lut_act.py::k4_plan)
MULTI_LENGTHS = (B * 3072, (1 << 22) + 3, 4, 5120 + 37)
# the element counts qwen3-0.6b form (f) hands K4 one site a call, at B
# requests of T tokens and a cache of T + NEW: decode attn_exp (4, 8, 2, 1,
# 80), norm_rsqrt (4, 1, 1), rope_table (1, 64); prefill (4, 8, 2, 64, 64),
# (4, 64, 1), (64, 64).  Phase 11 requires that the served calls have no
# other count.
SERVED_K4 = (5120, 4, 64, 262144, 256, 4096)


def site_edge_inputs(torch, entry, site, n, dtype, dev, gen):
    """``n`` inputs for ``site`` of a multi-site entry: every quantizer
    edge and grid point of its domain +-1 ulp of ``dtype`` first, then
    uniform draws across (and 5% beyond) the domain."""
    sm = entry["meta"]["site_meta"][site]
    lo, hi = sm["x_lo"], sm["x_hi"]
    span = hi - lo
    x = (torch.rand(n, generator=gen, device=dev) * 1.1 * span
         + (lo - 0.05 * span)).to(dtype)
    e = edge_values(torch, dtype, dev, w_in=sm["w_in"], x_lo=lo, x_hi=hi)
    e = e[torch.randperm(e.numel(), generator=gen, device=dev)]
    m = min(n, e.numel())
    x[:m] = e[:m]
    return x


def k4_held(torch, yk, yp, y1, what) -> None:
    """Fail unless K4's ``yk`` equals the plain K4's ``yp`` and K1's ``y1``
    bit for bit."""
    if not (bits_equal(torch, yk, yp) and bits_equal(torch, yk, y1)):
        raise AssertionError(
            f"K4 differs from its plain version or from K1: {what} "
            f"({int((yk != yp).sum())} / {int((yk != y1).sum())} elements)")


def check_multisite(dev, entry, gen) -> tuple[float, int]:
    """K4 bit for bit against its plain version and, per site, against K1
    on that site's slice of the super-slab, f32 and bf16, every layer:
    every per-layer site in one launch (the 8-segment entry, 16 bytes a
    thread), and each site alone (the served call's entry) at every count
    of ``SERVED_K4``, at the start of a buffer and one element past it,
    in both of its modes (one element a thread, 16 bytes a thread); two
    launches bit-identical; at the middle layer a single-site call and the
    all-sites call captured in a CUDA graph and replayed give eager's
    bits; an entry without its launch record is refused before anything
    launches.  Returns (largest difference, cases)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_act import k4_plan, lut_act_multi_plain
    from repro_torch.serve.stacked import multi_site_stacked_entry

    sites = entry["meta"]["sites"]
    slices = {s: multi_site_stacked_entry(entry, s) for s in sites}
    n_layers = entry["meta"]["n_layers"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, cases, modes = 0.0, 0, set()

    def same(a, b) -> bool:
        return all(bits_equal(torch, a[s], b[s]) for s in a)

    for dtype in (torch.float32, torch.bfloat16):
        xs = {s: site_edge_inputs(torch, entry, s, n, dtype, dev, gen)
              for s, n in zip(sites, MULTI_LENGTHS)}
        threads, vec, blocks = k4_plan(tuple(x.numel() for x in xs.values()),
                                       dtype, sm_count=sms)
        if max(blocks) < sms * 2048 // threads and len(sites) > 1:
            raise AssertionError(f"no segment of {MULTI_LENGTHS[:len(sites)]}"
                                 f" is past its block cap: {blocks}")
        for layer in range(n_layers):
            yk = ops.lut_act_multi(xs, entry, layer)
            yp = lut_act_multi_plain(xs, entry, layer)
            if not same(yk, ops.lut_act_multi(xs, entry, layer)):
                raise AssertionError(f"K4: two launches differ at layer "
                                     f"{layer} {dtype}")
            for s, x in xs.items():
                err = max(err, float((yk[s].float() - yp[s].float()).abs()
                                     .max()))
                k4_held(torch, yk[s], yp[s],
                        ops.lut_act_stacked(x, slices[s], layer),
                        f"all sites, site {s} layer {layer} {dtype}")
                cases += 1
        for s in sites:
            for n in SERVED_K4:
                buf = site_edge_inputs(torch, entry, s, n + 1, dtype, dev,
                                       gen)
                modes.add(k4_plan((n,), dtype, sm_count=sms)[1])
                for off, x in ((0, buf[:n]), (1, buf[1:])):
                    for layer in range(n_layers):
                        yk = ops.lut_act_multi({s: x}, entry, layer)[s]
                        yp = lut_act_multi_plain({s: x}, entry, layer)[s]
                        err = max(err, float((yk.float() - yp.float())
                                             .abs().max()))
                        k4_held(torch, yk, yp,
                                ops.lut_act_stacked(x, slices[s], layer),
                                f"site {s} alone, {n} elements at offset "
                                f"{off}, layer {layer} {dtype}")
                        cases += 1
        mid = n_layers // 2
        for group in [{s: xs[s][:5120]} for s in sites] + [xs]:
            eager = ops.lut_act_multi(group, entry, mid)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                replayed = ops.lut_act_multi(group, entry, mid)
            g.replay()
            torch.cuda.synchronize()
            if not same(replayed, eager):
                raise AssertionError(f"K4 replayed from a CUDA graph differs "
                                     f"from eager: {sorted(group)} {dtype}")
    if not (1 in modes and max(modes) > 1):
        raise AssertionError(f"K4's single-site checks ran in modes {modes}"
                             f" (elements a thread); both 1 and 16 bytes' "
                             f"worth are served")
    bare = {k: v for k, v in entry.items() if k != "k4_record"}
    before = ops.lut_act_multi.launches
    try:
        ops.lut_act_multi(xs, bare, 0)
    except ValueError as e:
        if "launch record" not in str(e):
            raise
    else:
        raise AssertionError("K4 ran on an entry without its launch record")
    if ops.lut_act_multi.launches != before:
        raise AssertionError("K4 launched on an entry without its record")
    torch.cuda.synchronize()
    return err, cases


def wkv_cases(torch, dev, gen, layer0):
    """K8's comparison cases at rwkv6-3b's prefill shape: layer 0's inputs
    from the real prefill, random inputs with strong and with weak decay,
    ``log_w`` at the model's bound ``-e`` and at ``-30`` on every step, a
    ragged T, chunk 16, and a given initial state."""
    q0, k0, v0, lw0, u0 = layer0
    b, t, h, n = q0.shape

    def rnd(hi):
        q, k, v = (torch.randn(b, t, h, n, generator=gen, device=dev)
                   for _ in range(3))
        lw = -torch.exp(torch.rand(b, t, h, n, generator=gen, device=dev)
                        * (hi + 3.0) - 3.0)
        return q, k, v, lw, torch.randn(h, n, generator=gen, device=dev)

    strong, weak = rnd(0.7), rnd(-1.0)   # log_w = -exp(U(-3, hi))
    s0 = torch.randn(b, h, n, n, generator=gen, device=dev) * 0.1
    at = lambda lw: strong[:3] + (torch.full_like(strong[3], lw), strong[4])
    return {
        "layer-0 prefill": ((q0, k0, v0, lw0, u0), 64, None),
        "strong decay": (strong, 64, None),
        "weak decay": (weak, 64, None),
        "log_w = -e": (at(-math.e), 64, None),
        "log_w = -30, initial state": (at(-30.0), 64, s0),
        "ragged T 48": (tuple(a[:, :48] for a in strong[:4])
                        + (strong[4],), 64, None),
        "ragged T 37, chunk 16, initial state": (
            tuple(a[:, :37] for a in strong[:4]) + (strong[4],), 16, s0),
        "chunk 16": (strong, 16, None),
        "initial state": (weak, 64, s0),
    }


def check_wkv(dev, cases) -> float:
    """K8 against its plain version on the card, ``rtol = atol = 1e-4`` on
    y and on the final state, finite, and two launches bit-identical.
    Returns the largest absolute difference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv import k8_plan, wkv_chunked_plain

    worst = 0.0
    for name, (args, chunk, s0) in cases.items():
        yk, sk = ops.wkv(*args, chunk=chunk, state=s0)
        y2, s2 = ops.wkv(*args, chunk=chunk, state=s0)
        yp, sp = wkv_chunked_plain(*args, chunk=chunk, state=s0)
        torch.cuda.synchronize()
        if not (torch.equal(yk, y2) and torch.equal(sk, s2)):
            raise AssertionError(f"K8 {name}: two launches differ")
        if not (torch.isfinite(yk).all() and torch.isfinite(sk).all()):
            raise AssertionError(f"K8 {name}: inf or nan")
        ey = float((yk - yp).abs().max())
        es = float((sk - sp).abs().max())
        worst = max(worst, ey, es)
        ok = (torch.allclose(yk, yp, rtol=1e-4, atol=1e-4)
              and torch.allclose(sk, sp, rtol=1e-4, atol=1e-4))
        log(f"    K8 {name} {tuple(args[0].shape)} chunk {chunk} "
            f"({k8_plan(*args[0].shape, chunk)}): max |y - plain| {ey:.3e}, "
            f"max |state - plain| {es:.3e} (|y| <= "
            f"{float(yp.abs().max()):.3g}); two launches bit-identical")
        if not ok:
            raise AssertionError(f"K8 differs from its plain version beyond "
                                 f"rtol = atol = 1e-4: {name}")
    return worst


def check_fused_nongated(dev, params, multi, lut, gen, site="ffn"):
    """K3 non-gated at rwkv6-3b's ``ffn`` shape and around it, through
    :func:`check_fused_case`: the serving M at three layers, the ragged M,
    an N that is not a multiple of the 128-column tile, a K that is not a
    multiple of S x 64 (stacked tables, held against K1), and ``lut``'s
    per-plan tables (held against K2).  Returns (largest difference from
    the plain path, {case: share differing})."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.stacked import multi_site_stacked_entry

    ws = params.blocks["w_ffn_k"]
    n_layers, k, n = ws.shape
    sl = multi_site_stacked_entry(multi, site)
    tab = lambda layer: {"multi_entry": multi, "site": site, "layer": layer}
    k1 = lambda layer: (lambda h: ops.lut_act_stacked(h, sl, layer))
    pa = lut.plan_arrays(packed=True, device=dev)
    ptab = {"meta": dict(lut.meta(), pack=pa.pack), "arrays": pa.arrays}
    k2 = lambda h: ops.lut_act(h, pa, x_lo=lut.x_lo, x_hi=lut.x_hi,
                               y_lo=lut.y_lo, y_hi=lut.y_hi)
    rand_x = lambda m, kk: torch.randn(m, kk, generator=gen, device=dev).to(
        ws.dtype)
    wstd = float(ws[0].float().std())
    rand_w = lambda kk, nn: (torch.randn(kk, nn, generator=gen, device=dev)
                             * wstd).to(ws.dtype)
    mid = n_layers // 2
    cases = [(f"M={m} layer {layer}", rand_x(m, k), ws[layer], tab(layer),
              k1(layer))
             for m in (B, B * T) for layer in (0, mid, n_layers - 1)]
    cases += [(f"M={m}", rand_x(m, k), ws[mid], tab(mid), k1(mid))
              for m in RAGGED_M]
    cases += [(f"M={m} per-plan", rand_x(m, k), ws[mid], ptab, k2)
              for m in (B, 67)]
    w_n, w_k = rand_w(k, 1000), rand_w(1032, n)
    for m in (B, 67):
        cases += [(f"N=1000 M={m}", rand_x(m, k), w_n, tab(mid), k1(mid)),
                  (f"K=1032 M={m}", rand_x(m, 1032), w_k, tab(mid), k1(mid))]
    err, share = 0.0, {}
    for label, x, w, t, lut_fn in cases:
        e, sh = check_fused_case(x, w, t, lut_fn, gated=False,
                                 label=f"non-gated {label}")
        err, share[label] = max(err, e), sh
    torch.cuda.synchronize()
    log(f"[9] K3 (non-gated) on {len(cases)} cases: bit-exact against its "
        f"own GEMM + K1 / K2, two launches bit-identical, share differing "
        f"from torch.matmul + plain LUT at most {max(share.values()):.6f}")
    return err, share


# K3's ragged token counts: 1, 3, 5 and 67 fill no token tile; 257 is one
# token past a multiple of every tile
RAGGED_M = (1, 3, 5, 67, 257)


def check_fused_case(x, w, tab, lut_fn, *, gated, label):
    """One K3 case: two launches bit-identical (the split-K sum is
    deterministic), bit for bit against the kernel's own GEMM
    (``epilogue=False``) followed by ``lut_fn`` (K1 or K2) and the gated
    product, and at most 1% of outputs differing from ``torch.matmul``
    followed by the plain LUT (bf16: bit for bit; f32: beyond rtol 1e-4).
    Returns (largest difference from the plain path, share differing);
    logs the plan."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_matmul_lut import (
        fused_matmul_lut_plain,
        k3_plan,
    )

    yk = ops.fused_matmul_lut(x, w, tab, gated=gated)
    again = ops.fused_matmul_lut(x, w, tab, gated=gated)
    h = ops.fused_matmul_lut(x, w, tab, gated=gated, epilogue=False)
    if gated:
        gate, up = h.chunk(2, dim=-1)
        yc = lut_fn(gate) * up
    else:
        yc = lut_fn(h)
    yp = fused_matmul_lut_plain(x, w, tab, gated=gated)
    if x.dtype == torch.float32:
        # up stays in f32, so the two GEMMs' sum orders reach every gated
        # output's last bits: count only differences past rtol 1e-4 (a bin
        # flip moves an output by a whole output level)
        differ = ~torch.isclose(yk, yp, rtol=1e-4, atol=1e-5)
    else:
        differ = yk != yp
    share = float(differ.float().mean())
    (m, k), n = x.shape, w.shape[1]
    plan = "f32 route" if x.dtype == torch.float32 else (
        lambda p: f"tokens {p.tok_tile} x {p.tok_tiles}, split {p.splits}, "
                  f"grid {p.grid}")(k3_plan(
                      m, k, n, gated=gated, dtype=x.dtype,
                      sm_count=torch.cuda.get_device_properties(
                          x.device).multi_processor_count))
    log(f"    K3 {label} ({m} x {k} x {n}, {plan}): share differing from "
        f"torch.matmul + plain LUT {share:.6f}")
    if not bits_equal(torch, yk, again):
        raise AssertionError(f"K3 {label}: two launches on the same inputs "
                             f"differ ({int((yk != again).sum())} elements)")
    if not bits_equal(torch, yk, yc):
        raise AssertionError(
            f"K3 {label}: differs from its own GEMM followed by the unfused "
            f"LUT ({int((yk != yc).sum())} elements)")
    if share > 0.01:
        raise AssertionError(f"K3 {label}: differs from the plain path on "
                             f"{share:.4%} of outputs (limit 1%)")
    return float((yk.float() - yp.float()).abs().max()), share


def largest_storages(n: int = 6) -> list:
    """The ``n`` largest storages on the card that Python objects still
    hold, as ``(bytes, a tensor's shape)``: what keeps memory allocated
    once a phase's models are deleted."""
    import torch

    gc.collect()
    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes(), tuple(o.shape)))
    return sorted(seen.values(), reverse=True)[:n]


def served_k4_shapes(launcher, params, cfg, batch, tables) -> dict:
    """``{"prefill": {site: [shape, ...]}, "decode": {...}}``: the input
    shapes the served form hands K4 in one prefill of ``batch`` and one
    decode step after it (:func:`served_lut_calls`, which holds every call
    bit for bit against the plain K4 and K1); the calls must have used
    both of K4's modes (one element a thread, 16 bytes a thread)."""
    from repro_torch.kernels.lut_act import k4_plan

    calls = [c for c in served_lut_calls(launcher, params, cfg, batch,
                                         tables)
             if c["kernel"] == "lut_act_multi" and c["x"].numel()]
    seen = {"prefill": {}, "decode": {}}
    for c in calls:
        shapes = seen[c["step"]].setdefault(c["site"], [])
        if tuple(c["x"].shape) not in shapes:
            shapes.append(tuple(c["x"].shape))
    if not seen["prefill"] or not seen["decode"]:
        raise AssertionError(f"the form served no site through K4: {seen}")
    sm_count = tables["multi"]["k4_record"].sm_count
    modes = {k4_plan((c["x"].numel(),), c["x"].dtype, sm_count=sm_count)[1]
             for c in calls}
    if not (1 in modes and max(modes) > 1):
        raise AssertionError(f"the served K4 calls ran in modes {modes}")
    log(f"[11] {len(calls)} served K4 calls of one prefill and one decode "
        f"step equal the plain K4 and K1 bit for bit (modes {sorted(modes)}"
        f" elements a thread)")
    return seen


def form_config(plans, cfg0, args):
    """The served config of a launcher form: the plans' patched config with
    the form's flags, as ``launch.serve.setup`` applies them."""
    cfg = plans.patched_config(cfg0) if plans is not None else cfg0
    return dataclasses.replace(cfg, lut_fuse=args.lut_fuse,
                               lut_sites=args.lut_sites,
                               logit_softcap=args.logit_softcap)


def check_captured(cfg, params, batch, tables, kv_int8=False) -> float:
    """Decode ``NEW`` steps after the prompt eagerly and through a
    :class:`CapturedStep` on a copy of the same cache, side by side: every
    replayed step's logits and the final caches must be bit-identical to
    eager's, and the wrappers' launch counts over the replays must be the
    eager steps'.  ``kv_int8``: the cache is int8, filled by an eager
    replay of the prompt.  Returns the capture's seconds."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (
        CapturedStep,
        decode_step,
        init_cache,
        prefill,
        prefill_replay,
    )

    toks = batch["tokens"]
    b, t = toks.shape
    eager = lambda c, tk, pos: decode_step(params, cfg, c, tk, pos, tables)
    logits, cache = prefill(params, cfg, batch, max_seq=t + NEW,
                            lut_tables=tables)
    if kv_int8:
        cache = init_cache(cfg, b, t + NEW, device=toks.device,
                           kv_dtype="int8")
        logits, cache = prefill_replay(params, cfg, cache, toks, 0, tables,
                                       step=eager)
    graph_cache = {k: v.clone() for k, v in cache.items()}
    step = CapturedStep(params, cfg, tables)
    step.capture(graph_cache, toks[:, :1])
    tok = logits[:, -1].argmax(-1)[:, None]
    counts = {}
    for i in range(NEW):
        for name, fn, c in (("eager", eager, cache),
                            ("graph", step, graph_cache)):
            reset_launch_counts()
            out, _ = fn(c, tok, t + i)
            counts[name] = launch_counts()
            if name == "eager":
                le = out
        if counts["eager"] != counts["graph"]:
            raise AssertionError(f"step {i}: a replay counted "
                                 f"{counts['graph']}, eager {counts['eager']}")
        if not bits_equal(torch, le, out):
            raise AssertionError(
                f"step {i}: the replayed logits differ from eager's "
                f"({int((le != out).sum())} of {le.numel()} elements, max "
                f"|diff| {float((le.float() - out.float()).abs().max())})")
        tok = le[:, -1].argmax(-1)[:, None]
    for k in cache:
        if not bits_equal(torch, cache[k], graph_cache[k]):
            raise AssertionError(f"the captured steps' cache {k!r} differs "
                                 f"from eager's")
    return step.capture_s


def serve_form(launcher, dev, label, args, cfg0, params, batch, plans, uses,
               results, totals, ref=None, want=None):
    """Serve one launcher form: a warm-up run, then a counted run (launch
    counts zeroed just before it and read just after), both decoding
    through the captured step; then an eager run, whose tokens must be
    the counted run's, and :func:`check_captured`.  ``ref`` is
    ``"gather"`` (tokens must equal the gather backend's on the same
    tables) or another form's label (token agreement is reported);
    ``want`` maps kernels to the exact launch count the run must show."""
    import argparse

    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    quiet = lambda m: None
    fcfg = form_config(plans, cfg0, args)
    tables = None if plans is None else launcher.serving_tables(
        args, plans, dev, log=quiet)
    launcher.serve(args, fcfg, params, batch, tables, log=quiet)
    reset_launch_counts()
    res = launcher.serve(args, fcfg, params, batch, tables, log=quiet)
    torch.cuda.synchronize()
    counts = launch_counts()
    if res["capture_s"] is None:
        raise AssertionError(f"form ({label}) decoded without a captured "
                             f"step")
    eager = launcher.serve(args, fcfg, params, batch, tables, log=quiet,
                           eager=True)
    if eager["tokens"] != res["tokens"]:
        raise AssertionError(
            f"form ({label}) captured tokens differ from eager's: "
            f"{res['tokens']} vs {eager['tokens']}")
    res["eager"] = {k: eager[k] for k in ("prefill_s", "replay_s",
                                          "decode_s", "decode_tok_s")}
    check_captured(fcfg, params, batch, tables, kv_int8=args.kv_int8
                   and fcfg.family in launcher.KV_INT8_FAMILIES)
    for k, v in counts.items():
        totals[k] += v
    for k in uses:
        if counts[k] == 0:
            raise AssertionError(f"form ({label}) launched no {k} kernel: "
                                 f"{counts}")
    for k, n in (want or {}).items():
        if counts[k] != n:
            raise AssertionError(f"form ({label}) launched {k} {counts[k]} "
                                 f"times, not {n}: {counts}")
    line = (f"({label}) {fcfg.name} exec={args.plan_exec} "
            f"fuse={args.lut_fuse} sites={args.lut_sites} softcap="
            f"{args.logit_softcap} kv_int8={args.kv_int8}: prefill "
            f"{res['prefill_s']:.4f}s"
            + (f", int8 replay {res['replay_s']:.4f}s (eager "
               f"{eager['replay_s']:.4f}s)" if res["replay_s"] else "")
            + f", capture {res['capture_s']:.4f}s, decode "
            f"{res['decode_tok_s']:.1f} tok/s captured, "
            f"{eager['decode_tok_s']:.1f} tok/s eager (tokens equal; "
            f"{NEW} replayed steps' logits and caches == eager's bit for "
            f"bit, launches as eager's)")
    if plans is not None:
        line += (f"; calib={plans.calib}, {plans.total_cost} P-LUTs, "
                 f"{launcher.tables_nbytes(tables)} table bytes")
    line += f"; launches {counts}"
    if ref == "gather":
        g_args = argparse.Namespace(**vars(args))
        g_args.lut_backend = "gather"
        g_tables = launcher.serving_tables(g_args, plans, dev, log=quiet)
        g = launcher.serve(g_args, fcfg, params, batch, g_tables, log=quiet)
        if g["tokens"] != res["tokens"]:
            raise AssertionError(
                f"form ({label}) tokens differ from the gather backend: "
                f"{res['tokens']} vs {g['tokens']}")
        line += (f"; tokens == gather (gather: prefill {g['prefill_s']:.4f}"
                 f"s, decode {g['decode_tok_s']:.1f} tok/s)")
        res["gather"] = {k: g[k] for k in ("prefill_s", "decode_s",
                                           "decode_tok_s")}
    elif ref is not None:
        agree = float(np.mean(np.array(results[ref]["tokens"])
                              == np.array(res["tokens"])))
        line += f"; token agreement with ({ref}): {agree:.4f}"
        res[f"agreement_with_{ref}"] = agree
    res["launches"] = counts
    log(line)
    log(f"    request 0: {res['tokens'][0]}")
    results[label] = res
    return res


# the batcher phase: 8 requests of 16-64 prompt tokens and 16 new tokens
# each through 4 slots of a cache of T + NEW positions
BATCHER_REQUESTS, BATCHER_SLOTS = 8, 4


def batcher_run(cfg, params, tables, prompts, *, kv_dtype="bfloat16",
                prefill="step", swap=None):
    """Serve ``prompts`` (``NEW`` tokens each) through a
    :class:`ContinuousBatcher`; ``swap``: ``(tick, tables, cfg)`` to swap
    to between ticks.  Returns ``(outs by request, batcher, seconds)``;
    with ``swap``, the batcher's ``served_before_swap`` holds each
    request's token count at the swap."""
    import torch

    from repro_torch.serve import ContinuousBatcher, Request

    b = ContinuousBatcher(cfg, params, BATCHER_SLOTS, T + NEW, eos_token=-1,
                          kv_dtype=kv_dtype, lut_tables=tables,
                          prefill=prefill)
    reqs = [Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    t0 = time.perf_counter()
    if swap is not None:
        while b.steps < swap[0]:
            b.step()
        b.served_before_swap = [len(r.out) for r in reqs]
        b.swap_tables(swap[1], cfg=swap[2])
    done = b.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [r.out for r in sorted(done, key=lambda r: r.rid)], b, secs


def run_batcher(launcher, dev, cfg0, params, batch, form_a, form_e,
                totals) -> dict:
    """Phase 13: qwen3-0.6b at full width with form (a)'s tables through
    the continuous batcher, bf16 and int8 caches, both prefill modes
    (launch counts zeroed before each run and read after it): replay and
    step serve the same tokens, no request is dropped, in bf16 every
    request's tokens equal its decode alone in the same pool; one
    ``swap_tables`` to form (e)'s tables mid-run captures the step again
    and serves on; and the replay prefill of the 4 x 64 prompts, bf16 and
    int8, timed through a captured step."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import CapturedStep, init_cache, prefill_replay

    quiet = lambda m: None
    (args_a, plans), (args_e, plans_e) = form_a, form_e
    cfg = form_config(plans, cfg0, args_a)
    cfg_e = form_config(plans_e, cfg0, args_e)
    tabs = launcher.serving_tables(args_a, plans, dev, log=quiet)
    tabs_e = launcher.serving_tables(args_e, plans_e, dev, log=quiet)
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(n))]
               for n in rng.integers(T // 4, T + 1, BATCHER_REQUESTS)]
    out = {"prompt_lens": [len(p) for p in prompts], "runs": {}}
    outs = {}
    batcher_run(cfg, params, tabs, prompts[:BATCHER_SLOTS])   # warm-up
    for kv in ("bfloat16", "int8"):
        for mode in ("step", "replay"):
            reset_launch_counts()
            got, b, secs = batcher_run(cfg, params, tabs, prompts,
                                       kv_dtype=kv, prefill=mode)
            counts = launch_counts()
            for k, v in counts.items():
                totals[k] += v
            m = b.metrics()
            if (counts["lut_act_stacked"] == 0 or m["dropped"]
                    or m["finished"] != len(prompts)
                    or any(len(o) != NEW for o in got)):
                raise AssertionError(f"batcher {kv} {mode}: launches "
                                     f"{counts}, metrics {m}")
            outs[kv, mode] = got
            new_tokens = sum(len(o) for o in got)
            out["runs"][f"{kv} {mode}"] = {
                "seconds": secs, "tok_s": new_tokens / secs,
                "ticks": m["ticks"], "utilization": m["utilization"],
                "replayed_tokens": m["replayed_tokens"],
                "captures": b._step.captures, "launches": counts,
                "latency_p50_s": m["latency_p50_s"],
                "ttft_p50_s": m["ttft_p50_s"]}
            log(f"[13] batcher {kv} prefill={mode}: {len(prompts)} requests "
                f"({sum(len(p) for p in prompts)} prompt tokens) in {secs:.3f}"
                f"s, {new_tokens / secs:.1f} new tok/s, {m['ticks']} ticks, "
                f"utilization {m['utilization']:.3f}, replayed "
                f"{m['replayed_tokens']}, latency p50 {m['latency_p50_s']:.3f}"
                f"s, ttft p50 {m['ttft_p50_s']:.3f}s, dropped 0; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
        if outs[kv, "step"] != outs[kv, "replay"]:
            raise AssertionError(f"batcher {kv}: replay tokens differ from "
                                 f"step tokens")
    alone = [batcher_run(cfg, params, tabs, [p])[0][0] for p in prompts]
    if alone != outs["bfloat16", "step"]:
        raise AssertionError(f"batcher bf16: a request's tokens differ from "
                             f"its decode alone: {outs['bfloat16', 'step']} "
                             f"vs {alone}")
    agree = float(np.mean(np.array(outs["int8", "step"])
                          == np.array(outs["bfloat16", "step"])))
    out["int8_agreement_with_bf16"] = agree
    log(f"[13] replay == step in bf16 and int8; every bf16 request's tokens "
        f"== its decode alone in the pool; int8 token agreement with bf16 "
        f"{agree:.4f}")
    # swap while the first slots are mid-decode: what they served before
    # the swap must be the unswapped run's, and the run must serve on
    tick = T + NEW // 2
    reset_launch_counts()
    swapped, b, secs = batcher_run(cfg, params, tabs, prompts,
                                   swap=(tick, tabs_e, cfg_e))
    counts = launch_counts()
    m = b.metrics()
    before = b.served_before_swap
    unswapped = outs["bfloat16", "step"]
    if (m["table_swaps"] != 1 or m["dropped"] or b._step.captures != 1
            or counts["lut_act_stacked"] == 0 or not sum(before)
            or any(len(o) != NEW for o in swapped)
            or any(o[:n] != u[:n]
                   for o, u, n in zip(swapped, unswapped, before))):
        raise AssertionError(f"batcher swap: metrics {m}, captures "
                             f"{b._step.captures}, launches {counts}, "
                             f"served before the swap {before}")
    after = [(o[n:], u[n:]) for o, u, n in zip(swapped, unswapped, before)]
    same = float(np.mean([x == y for o, u in after for x, y in zip(o, u)]))
    out["swap"] = {"tick": tick, "seconds": secs,
                   "served_before_swap": before,
                   "agreement_after_swap_with_unswapped": same}
    log(f"[13] swap_tables to form (e)'s tables at tick {tick}: the "
        f"{sum(before)} tokens served before it equal the unswapped run's; "
        f"captured again and served on ({m['finished']} finished, dropped "
        f"0) in {secs:.3f}s; token agreement after the swap with the "
        f"unswapped run {same:.4f}")
    replay = {}
    for kv in (None, "int8"):
        cache = init_cache(cfg, B, T + NEW, device=dev, kv_dtype=kv)
        step = CapturedStep(params, cfg, tabs)
        step.capture(cache, batch["tokens"][:, :1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_replay(params, cfg, cache, batch["tokens"], 0, step=step)
        torch.cuda.synchronize()
        replay[kv or "bfloat16"] = {"seconds": time.perf_counter() - t0,
                                    "capture_s": step.capture_s}
    out["replay_prefill"] = replay
    log(f"[13] replay prefill of {B} x {T} tokens through the captured "
        f"step: " + ", ".join(f"{k} {v['seconds']:.4f}s (capture "
                              f"{v['capture_s']:.4f}s)"
                              for k, v in replay.items()))
    return out


def check_artifacts(launcher, common, results) -> None:
    """Phase 14, through the launcher's entry points at full width:
    ``--calib-path`` saves the captured calibration and loads it back bit
    for bit, and serves from it the tokens of form (a); ``--save-plan``
    then ``--tuned-plan`` serve forms (a) and (f) token-identically to the
    in-process plans."""
    import contextlib
    import io

    from repro_torch.calib import load_calibration

    art = OUT_DIR / "artifacts"
    art.mkdir(exist_ok=True)
    for f in art.iterdir():
        f.unlink()
    quiet = lambda m: None

    def main(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return launcher.main(argv)

    calib_path = str(art / "calib")
    args = launcher.parse_args(common + ["--calib-steps", "2",
                                         "--calib-path", calib_path])
    cfg, params, _, _ = launcher.setup(args)
    captured = launcher.calibration(args, cfg, params, log=quiet)
    loaded = load_calibration(calib_path)
    for f in ("masks", "hists", "ranges"):
        a, b = getattr(captured, f), getattr(loaded, f)
        if sorted(a) != sorted(b) or any(
                a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()
                for k in a):
            raise AssertionError(f"--calib-path: {f} did not reload bit for "
                                 f"bit")
    if (captured.w_in, captured.x_lo, captured.x_hi) != (
            loaded.w_in, loaded.x_lo, loaded.x_hi):
        raise AssertionError("--calib-path: the quantizer did not reload")
    del params
    got = main(common + ["--calib-path", calib_path])["tokens"]
    if got != results["a"]["tokens"]:
        raise AssertionError("--calib-path: the reloaded calibration serves "
                             "other tokens than form (a)")
    log(f"[14] --calib-path: {len(loaded.masks)} masks, histograms and "
        f"ranges reload bit for bit; served from the file: tokens == (a)")
    for label, flags in (("a", ["--calib-steps", "2"]),
                         ("f", ["--calib-steps", "2", "--lut-sites", "all",
                                "--lut-fuse"])):
        path = str(art / f"plan_{label}")
        saved = main(common + flags + ["--save-plan", path])["tokens"]
        served = main([a for a in common if a != "--lut-act"]
                      + flags[2:] + ["--tuned-plan", path])["tokens"]
        if not (saved == served == results[label]["tokens"]):
            raise AssertionError(f"--tuned-plan ({label}): {served} vs saved "
                                 f"{saved} vs form {results[label]['tokens']}")
        log(f"[14] --save-plan then --tuned-plan, form ({label}): tokens == "
            f"the in-process plans' ({Path(path + '.npz').stat().st_size} "
            f"bytes)")


def logit_drift(launcher, dev, cfg0, params, batch, a, b) -> dict:
    """How far form ``b`` moves the last-token prefill logits from form
    ``a`` (each ``(args, plans)``, plans ``None`` for the exact model),
    beside ``a``'s top-1 margin: the yardstick for a token agreement."""
    import torch

    def logits(args, plans):
        tabs = None if plans is None else launcher.serving_tables(
            args, plans, dev, log=lambda m: None)
        lg, _ = launcher.prefill(params, form_config(plans, cfg0, args),
                                 batch, max_seq=T, lut_tables=tabs)
        return lg[:, -1].float()

    la, lb = logits(*a), logits(*b)
    top2 = torch.topk(la, 2, dim=-1).values
    return {"max_abs_diff": float((la - lb).abs().max()),
            "mean_abs_diff": float((la - lb).abs().mean()),
            "logit_std": float(la.std()),
            "top1_margin": [float(m) for m in top2[:, 0] - top2[:, 1]],
            "same_argmax": [bool(x) for x in
                            la.argmax(-1) == lb.argmax(-1)]}


# -------------------------------------------------------------------------
# phase 15: the moe family at full width
# -------------------------------------------------------------------------
# the LUT kernels; phase 15's exact forms must launch none of them
MOE_LUT = ("lut_act_stacked", "lut_act", "fused_matmul_lut", "lut_act_multi")
# the forms phase 15 serves each moe configuration in, and the form each
# is held against: "gather" (token-identical to the gather backend on the
# same tables) or another form (token agreement reported)
MOE_FORMS = {"deepseek-moe-16b": ("exact", "a", "b", "d", "f", "k"),
             "qwen3-moe-30b-a3b": ("exact", "a")}
MOE_REFS = {"exact": None, "a": "gather", "b": "gather", "d": "a",
            "f": "exact", "k": "a"}


def same_layout(x):
    """A copy of ``x`` laid out as ``x`` is: a strided view (``rows`` rows
    of ``cols`` elements, ``ld`` apart, as the gate half of an expert's
    ``[gate|up]`` product) stays one, at a 16-byte aligned start."""
    import torch

    from repro_torch.kernels.lut_act import k1_view

    if x.is_contiguous():
        return x.clone()
    rows, cols, ld = k1_view(x)
    buf = torch.zeros((rows, ld), dtype=x.dtype, device=x.device)
    buf[:, :cols] = x.reshape(rows, cols)
    return buf[:, :cols].view(x.shape)


def served_lut_calls(launcher, params, cfg, batch, tables) -> list:
    """Every K1 / K2 / K4 call one prefill of ``batch`` and one decode step
    after it make in a served form (seen where the wrappers launch:
    ``launch_lut`` for K1 / K2, ``k4_call`` for K4), each with a copy of
    its input in the served layout, its output and its site's table entry
    as ``apply_lut_act`` takes it; every call is held bit for bit against
    the plain version on its input (K4 also against K1 per site), and the
    kernel on the copy against the served output."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.nn.mlp import apply_lut_act
    from repro_torch.serve.stacked import multi_site_stacked_entry

    entries = {}    # id(launch record) -> (site, entry as apply_lut_act's)
    for site, e in tables["sites"].items():
        if "stacked" in e:
            entries[id(e["stacked"]["k1_record"])] = (site, e["stacked"])
        for le in e.get("layers", ()):
            entries[id(le["k1_record"])] = (site, le)
    calls, step = [], ["prefill"]
    orig_k12, orig_k4 = ops.launch_lut, ops.k4_call

    def k12(fn, name, x, rec, layer):
        y = orig_k12(fn, name, x, rec, layer)
        site, e = entries[id(rec)]
        tab = {"stacked": e, "layer": layer} if name == "lut_act_stacked" \
            else e
        calls.append(dict(kernel=name, step=step[0], site=site, layer=layer,
                          x=same_layout(x), y=y, tab=tab))
        return y

    def k4(xs, rec, layer):
        if rec is not tables["multi"]["k4_record"]:
            raise AssertionError("K4 served from another entry's record")
        out, call = orig_k4(xs, rec, layer)
        for s, x in xs.items():
            calls.append(dict(kernel="lut_act_multi", step=step[0], site=s,
                              layer=layer, x=same_layout(x), y=out[s],
                              tab={"multi_entry": tables["multi"], "site": s,
                                   "layer": layer}))
        return out, call

    ops.launch_lut, ops.k4_call = k12, k4
    try:
        logits, cache = launcher.prefill(params, cfg, batch, max_seq=T + NEW,
                                         lut_tables=tables)
        step[0] = "decode"
        launcher.decode_step(params, cfg, cache,
                             logits[:, -1].argmax(-1)[:, None], T, tables)
        torch.cuda.synchronize()
    finally:
        ops.launch_lut, ops.k4_call = orig_k12, orig_k4
    slices = {}
    for c in calls:
        x, y, tab = c["x"], c["y"], c["tab"]
        what = (f"{c['kernel']} {c['step']} site {c['site']} "
                f"{tuple(x.shape)} layer {c['layer']}")
        again = apply_lut_act(x, tab, "cuda")
        yp = apply_lut_act(x, tab, "gather")
        if c["kernel"] == "lut_act_multi":
            sl = slices.setdefault(c["site"], multi_site_stacked_entry(
                tables["multi"], c["site"]))
            k4_held(torch, y, yp, ops.lut_act_stacked(x, sl, c["layer"]),
                    f"served call {what}")
        if not (bits_equal(torch, y, yp) and bits_equal(torch, y, again)):
            raise AssertionError(
                f"served {what}: the kernel differs from its plain version "
                f"or from itself on a copy ({int((y != yp).sum())} / "
                f"{int((y != again).sum())} elements)")
    return calls


def lut_call_timing(c, name) -> dict:
    """One served call's kernel timed (from a CUDA graph and host-driven)
    beside its plain version and its bound from bytes: its input read and
    output written once, and one layer's slab of its site."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.lut_act import k1_view
    from repro_torch.nn.mlp import apply_lut_act
    from repro_torch.serve.stacked import multi_site_stacked_entry

    x, layer, tab = c["x"], c["layer"], c["tab"]
    kfn = lambda: apply_lut_act(x, tab, "cuda")
    pfn = lambda: apply_lut_act(x, tab, "gather")
    if c["kernel"] == "lut_act_stacked":
        arrays = {k: a[layer] for k, a in tab["stacked"]["arrays"].items()}
    elif c["kernel"] == "lut_act":
        arrays = tab["arrays"]
    else:
        arrays = {k: a[layer] for k, a in multi_site_stacked_entry(
            tab["multi_entry"], c["site"])["arrays"].items()}
    slab = sum(int(a.numel()) * 4 for a in arrays.values())
    n = x.numel()
    # operations an element: phase 11's count, 5 for K1 / K2, 20 for K4
    per = 20 if c["kernel"] == "lut_act_multi" else 5
    bms, by = bound(2 * n * x.element_size() + slab, per * n, PEAK_F32_FLOPS)
    before = launch_counts()[c["kernel"]]
    ops_run = torch_ops_of(kfn)
    launched = launch_counts()[c["kernel"]] - before
    t = {"name": name, "kernel": c["kernel"], "site": c["site"],
         "step": c["step"], "shape": list(x.shape),
         "layout": "contiguous" if x.is_contiguous() else
         f"strided view, row stride {k1_view(x)[2]}",
         "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
         "plain_ms": timed_ms(pfn, n=10, warmup=2, reps=3),
         "bound_ms": bms, "bound_by": by,
         "launches_a_call": launched,
         "torch_ops": ops_run, "copies": sum(o in COPY_OPS for o in ops_run)}
    if c["kernel"] == "lut_act_multi" and not x.is_contiguous():
        # K4 copies a strided input before its launch (k4_call): the
        # same call on a contiguous copy shows what the copy costs
        xc = x.contiguous()
        cfn = lambda: apply_lut_act(xc, tab, "cuda")
        t.update(contiguous_ms=timed_ms(cfn), contiguous_graph_ms=graph_ms(
            cfn))
    return t


def moe_timings(calls, label) -> list:
    """Time each distinct (kernel, site, step, shape) the served calls
    show, at the middle one of its layers."""
    groups = {}
    for c in calls:
        key = (c["kernel"], c["site"], c["step"], tuple(c["x"].shape),
               c["x"].stride())
        groups.setdefault(key, []).append(c)
    out = []
    for key, cs in groups.items():
        t = lut_call_timing(cs[len(cs) // 2], label)
        t["calls"] = len(cs)
        out.append(t)
        log(f"[15] {label} {t['kernel']} {t['site']} {t['step']} "
            f"{t['shape']} ({t['layout']}, {t['calls']} calls): "
            f"{t['graph_ms'] * 1e3:.2f} us a launch from a graph "
            f"({t['ms'] * 1e3:.2f} host-driven), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
            f"{t['plain_ms'] * 1e3:.2f} us; {t['launches_a_call']} launch "
            f"a call, PyTorch ops around it {t['torch_ops']}"
            + (f" (on a contiguous input {t['contiguous_graph_ms'] * 1e3:.2f}"
               f" us from a graph)" if "contiguous_ms" in t else ""))
    return out


def prefill_drops(launcher, params, cfg, batch, tables) -> int:
    """Routed assignments dropped by capacity over one prefill of
    ``batch`` (every layer), counted where the routing computes them."""
    import torch

    from repro_torch.nn import moe as moe_mod

    orig, drops = moe_mod.route, []

    def spy(*a, **kw):
        r = orig(*a, **kw)
        drops.append(r.dropped())
        return r

    moe_mod.route = spy
    try:
        launcher.prefill(params, cfg, batch, max_seq=T, lut_tables=tables)
    finally:
        moe_mod.route = orig
    if len(drops) != cfg.n_layers:
        raise AssertionError(f"the prefill routed {len(drops)} times, not "
                             f"once a layer ({cfg.n_layers})")
    return int(torch.stack(drops).sum())


def k3_times(x, ws, tab, sl, layer, *, gated, n=50) -> dict:
    """K3 on ``x`` (M, K) bf16 against a stack of weights ``ws`` (L, K, N),
    a layer's weight in turn each launch (L2-cold, as a decode step meets
    them), from a CUDA graph and host-driven, beside its plain version,
    cuBLAS alone and the library yardstick, cuBLAS followed by K1 (``sl``,
    the site's stacked slice, at ``layer``) and the gated product: form
    (a)'s unfused path.  The bound: inputs read and output written once,
    the layer's slab, and ``2 M K N`` bf16 operations."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain

    it = iter(range(10 ** 9))
    w = lambda: ws[next(it) % len(ws)]
    kfn = lambda: ops.fused_matmul_lut(x, w(), tab, gated=gated)
    pfn = lambda: fused_matmul_lut_plain(x, w(), tab, gated=gated)
    mfn = lambda: torch.matmul(x, w())

    def lfn():
        h = torch.matmul(x, w())
        if not gated:
            return ops.lut_act_stacked(h, sl, layer)
        gate, up = h.chunk(2, dim=-1)
        return ops.lut_act_stacked(gate, sl, layer) * up
    (m, k), n_out = x.shape, ws[0].shape[1]
    slab = sum(int(a[layer].numel()) * 4 for a in sl["arrays"].values())
    bms, by = bound(2 * (m * k + k * n_out + m * (n_out // 2 if gated
                                                   else n_out)) + slab,
                    2 * m * k * n_out, PEAK_BF16_FLOPS)
    return {"shape": [m, k, n_out], "ms": timed_ms(kfn, n=n),
            "graph_ms": graph_ms(kfn, n=n), "plain_ms": timed_ms(pfn, n=10),
            "bound_ms": bms, "bound_by": by, "library_ms": timed_ms(lfn, n=n),
            "library_graph_ms": graph_ms(lfn, n=n),
            "matmul_only_ms": timed_ms(mfn, n=n),
            "matmul_only_graph_ms": graph_ms(mfn, n=n)}


def check_shared_k3(dev, params, tables, gen) -> dict:
    """K3 at deepseek's shared-expert shape (K = d_model, N = 2 x 2816,
    gated) on form (d)'s super-slab: against its own GEMM + K1 and within
    1% of the plain path, at the decode and prefill M and ragged M; timed
    beside the plain version and cuBLAS + K1 (rotating the 28 layers'
    weights, L2-cold)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.stacked import multi_site_stacked_entry

    multi = tables["multi"]
    sl = multi_site_stacked_entry(multi, "mlp")
    w = params.blocks["sh_w_in"]
    L, K = w.shape[:2]
    tab = lambda layer: {"multi_entry": multi, "site": "mlp", "layer": layer}
    k1 = lambda layer: (lambda g: ops.lut_act_stacked(g, sl, layer))
    shares = {}
    for m in (B, B * T, 67):
        for layer in (0, L // 2, L - 1):
            x = torch.randn(m, K, generator=gen, device=dev).to(
                torch.bfloat16)
            _, shares[f"M={m} layer {layer}"] = check_fused_case(
                x, w[layer], tab(layer), k1(layer), gated=True,
                label=f"shared expert M={m} layer {layer}")
    out = {"mismatch_share_vs_plain": shares}
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        out[shape_name] = t = k3_times(x, w, tab(L // 2), sl, L // 2,
                                       gated=True)
        log(f"[15] K3 shared expert {shape_name} {t['shape']}: "
            f"{t['graph_ms'] * 1e3:.2f} us from a graph ({t['ms'] * 1e3:.2f} "
            f"host-driven), bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, cuBLAS + "
            f"K1 {t['library_graph_ms'] * 1e3:.2f} us from a graph "
            f"({t['library_ms'] * 1e3:.2f}), cuBLAS alone "
            f"{t['matmul_only_graph_ms'] * 1e3:.2f} us")
    return out


def run_moe_model(launcher, dev, arch, totals, results, stamp) -> dict:
    """Phase 15 for one moe configuration at full width (random weights
    from seed 0, bf16): plans from 2 calibration batches; the served forms
    ``MOE_FORMS[arch]`` through :func:`serve_form`, each
    captured and eager, with the launch counts its sites imply; every
    K1 / K2 / K4 call of a prefill and a decode step in forms (a), (b) and
    (f) held bit for bit against its plain version and timed; K1 on the
    expert gate view launching one kernel; the prefill's dropped
    assignments; K3 at the shared-expert shape (form (d)); one eager and
    one captured decode step profiled (exact and (a))."""
    import torch

    from repro_torch.nn.moe import moe_capacity

    labels = MOE_FORMS[arch]
    gen = torch.Generator(device=dev).manual_seed(15)
    parse = launcher.parse_args
    common = ["--arch", arch, "--full", "--batch", str(B), "--prompt-len",
              str(T), "--new-tokens", str(NEW), "--device", "cuda"]
    lut = common + ["--lut-act", "--calib-steps", "2"]
    args = {"exact": parse(common), "a": parse(lut),
            "b": parse(lut + ["--plan-exec", "unrolled"]),
            "d": parse(lut + ["--lut-fuse"]),
            "f": parse(lut + ["--lut-sites", "all", "--lut-fuse"]),
            "k": parse(lut + ["--kv-int8"])}
    torch.cuda.init()   # the allocator, before its peak is reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg0, params, batch, rng = launcher.setup(args["exact"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = cfg0.moe
    n_params = sum(p.numel() for p in params.parameters())
    out = {"arch": arch, "init_s": init_s, "n_params": n_params,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_after_params": torch.cuda.max_memory_allocated(dev)}
    log(f"[15] {cfg0.name}: {cfg0.n_layers} layers, d_model {cfg0.d_model}, "
        f"{cfg0.n_heads}/{cfg0.n_kv_heads} heads x {cfg0.d_head}, "
        f"{m.n_experts} experts top-{m.top_k} at d_expert {m.d_expert}, "
        f"{m.n_shared} shared, vocab {cfg0.vocab_size}, {cfg0.dtype}; "
        f"{launcher.param_summary(params)}; built in {init_s:.1f}s")
    quiet = lambda msg: None
    plans = launcher.build_plans(args["a"], cfg0, params, rng,
                                 log=lambda msg: log("    " + msg))
    plans_all = None
    if "f" in labels:
        plans_all = launcher.build_plans(
            args["f"], form_config(None, cfg0, args["f"]), params, rng,
            log=lambda msg: log("    " + msg))
    plan_of = {"exact": None, "f": plans_all}

    def served(label):
        """A form's served config and tables."""
        pl = plan_of.get(label, plans)
        tabs = (None if pl is None else
                launcher.serving_tables(args[label], pl, dev, log=quiet))
        return form_config(pl, cfg0, args[label]), tabs

    L, sites_a = cfg0.n_layers, len(plans.sites)
    steps = 1 + NEW                      # the prefill and NEW replays
    per_layer_f = 8   # expert, attn_exp, norm_rsqrt x 2, rope_table x 4
    forms = {   # the kernels a form must launch, and how often
        "exact": ([], {k: 0 for k in MOE_LUT}),
        "a": (["lut_act_stacked"], {"lut_act_stacked": steps * L * sites_a}),
        "b": (["lut_act"], {"lut_act": steps * L * sites_a}),
        # the shared MLP through K3, the expert site out of the super-slab
        "d": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L, "lut_act_multi": steps * L}),
        "f": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L,
               "lut_act_multi": steps * L * per_layer_f}),
        # one prefill, T replays into the int8 cache, NEW decode replays
        "k": (["lut_act_stacked"],
              {"lut_act_stacked": (1 + T + NEW) * L * sites_a}),
    }
    tag = "ds" if m.n_shared else "q3m"
    out["forms"] = {}
    for label in labels:
        uses, want = forms[label]
        ref = MOE_REFS[label]
        log(f"[15] {stamp()}")
        res = serve_form(launcher, dev, f"{tag} {label}", args[label], cfg0,
                         params, batch, plan_of.get(label, plans), uses,
                         results, totals, ref=ref if ref in (None, "gather")
                         else f"{tag} {ref}", want=want)
        out["forms"][label] = {k: v for k, v in res.items()
                               if k != "tokens"}
    # the served K1 / K2 / K4 calls at the moe shapes
    out["lut_calls"] = []
    for label in [l for l in ("a", "b", "f") if l in labels]:
        fcfg, tabs = served(label)
        calls = served_lut_calls(launcher, params, fcfg, batch, tabs)
        log(f"[15] form ({tag} {label}): {len(calls)} served K1/K2/K4 calls "
            f"of one prefill and one decode step equal their plain "
            f"versions bit for bit (K4 also K1 per site)")
        out["lut_calls"] += moe_timings(calls, f"{tag} {label}")
        del calls
    # K1 reads the expert gate view in place: one launch, no copy
    for t in out["lut_calls"]:
        if t["kernel"] == "lut_act_stacked" and (
                t["launches_a_call"], t["copies"]) != (1, 0):
            raise AssertionError(
                f"K1 at {t['shape']} ({t['layout']}): {t['launches_a_call']}"
                f" launches a call and the PyTorch ops {t['torch_ops']}, not "
                f"one launch and no copy")
    drops = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        drops[label] = prefill_drops(launcher, params, fcfg, batch, tabs)
    out["capacity"] = {"prefill": moe_capacity(B * T, m),
                       "decode": moe_capacity(B, m)}
    out["prefill_dropped"] = drops
    log(f"[15] {tag}: capacity {out['capacity']['prefill']} slots an expert "
        f"at prefill ({B * T} tokens x top-{m.top_k} over {m.n_experts}), "
        f"{out['capacity']['decode']} at decode; prefill assignments "
        f"dropped by capacity: {drops} of {B * T * m.top_k * L}")
    if m.n_shared and "d" in labels:
        out["shared_k3"] = check_shared_k3(dev, params, served("d")[1], gen)
    out["steps"] = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        out["steps"][label] = profile_decode_step(
            launcher, f"{tag} {label}", fcfg, params, batch, tabs, tag="15")
    logits, _ = launcher.prefill(params, cfg0, batch, max_seq=T + 1)
    if logits.shape != (B, 1, cfg0.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    log(f"[15] {tag}: parameters {out['param_bytes']} bytes, peak allocated "
        f"{out['peak_after_params']} after the parameters, "
        f"{out['peak']} over the phase")
    return out


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
    from repro_torch.kernels.lut_act import (
        lut_act_multi_plain,
        lut_act_plain,
        lut_act_stacked_plain,
    )
    from repro_torch.kernels.wkv import wkv_chunked_plain
    from repro_torch.launch import serve as launcher
    from repro_torch.nn import ssm as ssm_mod
    from repro_torch.nn.lut_act import build_lut_activation
    from repro_torch.serve import verify_backend_equivalence
    from repro_torch.serve.stacked import (
        StackedPlanArrays,
        multi_site_stacked_entry,
    )

    t_start = time.perf_counter()
    stamp = lambda: f"[{time.perf_counter() - t_start:.0f}s]"
    OUT_DIR.mkdir(exist_ok=True)
    LOG.append(open(OUT_DIR / "chip_smoke.log", "w"))
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
    sass = k3_sass_counts(build, built["fused_matmul_lut"]["path"])
    log(f"[2] K3's bf16 kernels in SASS (cuobjdump -sass): "
        + ", ".join(f"{k}: {v['HGMMA']} HGMMA, {v['UTMALDG']} UTMALDG"
                    for k, v in sass.items())
        + f"; K8: {k8_hmma_count(build, built['wkv']['path'])} HMMA "
          f"(TF32 mma.sync)")

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
    log(f"[3] {stamp()} {cfg0.name}: {cfg0.n_layers} layers, d_model "
        f"{cfg0.d_model}, d_ff {cfg0.d_ff}, vocab {cfg0.vocab_size}, "
        f"{cfg0.dtype}; "
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
    # path A: every LUT site (--lut-sites all), and with the logit softcap
    args_e = parse(common + ["--calib-steps", "2", "--lut-sites", "all"])
    args_f = parse(common + ["--calib-steps", "2", "--lut-sites", "all",
                             "--lut-fuse"])
    args_g = parse(common + ["--calib-steps", "2", "--lut-sites", "all",
                             "--logit-softcap", "30"])
    plans_all = launcher.build_plans(
        args_e, form_config(None, cfg0, args_e), params, rng,
        log=lambda m: log("    " + m))
    plans_cap = launcher.build_plans(
        args_g, form_config(None, cfg0, args_g), params, rng,
        log=lambda m: log("    " + m))

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
    log(f"[4] {stamp()} K1/K2 bit-exact against their plain versions on "
        f"{checked} (slab, layer, shape, dtype) cases")
    # the layouts the serving path gives K1 / K2, on every site's stack of
    # the all-sites plans and the mixed stack, and K2 on per-layer plans
    site_stacks = plans_all.tables_for_model(backend="cuda", device=dev)
    lay_stacks = {f"{site} packed": e["stacked"]
                  for site, e in site_stacks["sites"].items()
                  if "stacked" in e}
    lay_stacks["mixed-packed"] = stacks["mixed-packed"]
    lay_stacks["mixed-raw"] = stacks["mixed-raw"]
    lay_luts = {"shared": shared.sites["mlp"].lut, "w_lb0": mixed[0],
                "w_lb2": mixed[1]}
    lay_luts.update({f"{site} layer {i}": sp.luts[i]
                     for site, sp in plans_all.sites.items() if sp.per_layer
                     for i in (0, cfg.n_layers - 1)})
    lay_cases, lay_widths = check_k1_layouts(dev, lay_stacks, lay_luts, gen)
    gate = k1_layouts(torch, B, torch.bfloat16, dev, gen)["gate view"]
    k1_kernels = kernels_of(
        lambda: ops.lut_act_stacked(gate, stacks["packed"], 0))
    if len(k1_kernels) != 1:
        raise AssertionError(f"K1 on the gate view launched {k1_kernels}, "
                             f"not one kernel")
    log(f"[4] {stamp()} K1/K2 bit-exact on {lay_cases} more cases: the gate "
        f"and up halves of [gate|up] (row stride 6144), a start 2 / 4 bytes "
        f"past a 16-byte boundary, counts 1, 7 and 8003, stacks "
        f"{sorted(lay_stacks)} (any_lb with a w_lb == 0 layer: mixed), pack "
        f"widths {lay_widths}; K1 on the gate view launches one kernel "
        f"({k1_kernels[0][:60]}) and no copy")

    f_tables = plans.tables_for_model(backend="cuda", kernel="fused",
                                      device=dev)
    ftab = lambda layer: {"multi_entry": f_tables["multi"], "site": "mlp",
                          "layer": layer}
    f_slice = multi_site_stacked_entry(f_tables["multi"], "mlp")
    # K3: the serving shapes, then ragged and repeated cases; stacked tables
    # (held against K1) and per-plan tables (shared or unrolled tables under
    # --lut-fuse: scalars as kernel arguments, held against K2)
    L, K = cfg.n_layers, cfg.d_model
    w_in = params.blocks["w_in"]
    lut = shared.sites["mlp"].lut
    pa_sh = lut.plan_arrays(packed=True, device=dev)
    ptab = {"meta": dict(lut.meta(), pack=pa_sh.pack), "arrays": pa_sh.arrays}
    k2 = lambda g: ops.lut_act(g, pa_sh, x_lo=lut.x_lo, x_hi=lut.x_hi,
                               y_lo=lut.y_lo, y_hi=lut.y_hi)
    k1 = lambda layer: (lambda g: ops.lut_act_stacked(g, f_slice, layer))
    rand_x = lambda m, k: torch.randn(m, k, generator=gen, device=dev).to(
        torch.bfloat16)
    wstd = float(w_in[0].float().std())
    rand_w = lambda k, n: (torch.randn(k, n, generator=gen, device=dev)
                           * wstd).to(torch.bfloat16)
    cases = []   # (label, x, w, site entry, the unfused LUT)
    for m in (B, B * T):
        for layer in (0, L // 2, L - 1):
            cases.append((f"M={m} layer {layer}", rand_x(m, K), w_in[layer],
                          ftab(layer), k1(layer)))
        cases.append((f"M={m} per-plan", rand_x(m, K), w_in[0], ptab, k2))
    for m in RAGGED_M:
        x = rand_x(m, K)
        cases += [(f"M={m}", x, w_in[L // 2], ftab(L // 2), k1(L // 2)),
                  (f"M={m} per-plan", x, w_in[0], ptab, k2)]
    w_f = rand_w(K, 2000)               # F = 1000: not a multiple of 64
    w_k = rand_w(1032, w_in.shape[2])   # K = 1032: not a multiple of S x 64
    for m in (B, 67):
        cases += [(f"F=1000 M={m}", rand_x(m, K), w_f, ftab(L // 2),
                   k1(L // 2)),
                  (f"F=1000 M={m} per-plan", rand_x(m, K), w_f, ptab, k2),
                  (f"K=1032 M={m}", rand_x(m, 1032), w_k, ftab(L // 2),
                   k1(L // 2)),
                  (f"K=1032 M={m} per-plan", rand_x(m, 1032), w_k, ptab, k2)]
    # the f32 route (CUDA cores) at one shape
    cases.append((f"f32 M={B}", rand_x(B, K).float(), w_in[L // 2].float(),
                  ftab(L // 2), k1(L // 2)))
    k3_mismatch = {}
    for label, x, w, tab, lut_fn in cases:
        err, share = check_fused_case(x, w, tab, lut_fn, gated=True,
                                      label=label)
        max_err["fused_matmul_lut"] = max(max_err["fused_matmul_lut"], err)
        k3_mismatch[label] = share
    torch.cuda.synchronize()
    log(f"[4] {stamp()} K3 (gated) on {len(cases)} cases: bit-exact against "
        f"its own GEMM + K1 (stacked) / K2 (per-plan), two launches "
        f"bit-identical, share differing from torch.matmul + plain LUT at "
        f"most {max(k3_mismatch.values()):.6f}")

    a_tables = plans_all.tables_for_model(backend="cuda", kernel="fused",
                                          device=dev)
    a_multi = a_tables["multi"]
    k4_err, k4_cases = check_multisite(dev, a_multi, gen)
    max_err["lut_act_multi"] = k4_err
    log(f"[4] {stamp()} K4 bit-exact against its plain version and against "
        f"K1 per site on {k4_cases} (site, layer, dtype, launch) cases: "
        f"sites {a_multi['meta']['sites']} in one launch per layer, segment"
        f" lengths {MULTI_LENGTHS}, and each site alone at {SERVED_K4} "
        f"elements, aligned and one element past, both modes; f32 and "
        f"bf16, bin edges +-1 ulp; two "
        f"launches bit-identical; single-site and all-sites calls replayed "
        f"from a CUDA graph give eager's bits; an entry without its launch "
        f"record is refused")

    # ---- 5. the serving path, qwen3-0.6b (path A: forms e-g) --------------
    results = {}
    totals = {k: 0 for k in launch_counts()}
    quiet = lambda m: None
    # the exact activation (no LUT) on the same weights, as a yardstick
    launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    exact = launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    log(f"[5] {stamp()} exact (no LUT): prefill {exact['prefill_s']:.4f}s, "
        f"decode {exact['decode_tok_s']:.1f} tok/s")
    forms = [
        ("a", args_a, plans, ["lut_act_stacked"], "gather"),
        ("b", parse(common + ["--calib-steps", "2", "--plan-exec",
                              "unrolled"]), plans, ["lut_act"], "gather"),
        ("c", args_c, shared, ["lut_act"], "gather"),
        ("d", parse(common + ["--calib-steps", "2", "--lut-fuse"]), plans,
         ["fused_matmul_lut"], "a"),
        ("e", args_e, plans_all, ["lut_act_stacked"], "gather"),
        ("f", args_f, plans_all, ["fused_matmul_lut", "lut_act_multi"],
         "e"),
        ("g", args_g, plans_cap, ["lut_act_stacked", "lut_act"], "gather"),
        ("k", parse(common + ["--calib-steps", "2", "--kv-int8"]), plans,
         ["lut_act_stacked"], "a"),
    ]
    for label, args, pl, uses, ref in forms:
        log(f"[5] {stamp()}")
        serve_form(launcher, dev, label, args, cfg0, params, batch, pl, uses,
                   results, totals, ref=ref)
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

    # ---- 13. the continuous batcher and 14. artifacts (run here, so that
    # the batcher's launches count on the main path) ------------------------
    log(f"[13] {stamp()}")
    batcher = run_batcher(launcher, dev, cfg0, params, batch,
                          (args_a, plans), (args_e, plans_all), totals)
    log(f"[14] {stamp()}")
    check_artifacts(launcher, common, results)

    # ---- 6. K5/K6 and 7. K7 against their plain versions on the card ------
    errors = check_gather_kernels(dev)
    errors["lutnn_layer"] = check_lutnn_layer(dev)

    # ---- 8. the LUT-NN toolflows (paper width), quickstart ---------------
    log(f"[8] {stamp()}")
    flow = run_toolflow(dev)

    # ---- 9. rwkv6-3b (path B): model, plans, K3 non-gated and K8 ----------
    rcommon = ["--arch", "rwkv6-3b", "--full", "--batch", str(B),
               "--prompt-len", str(T), "--new-tokens", str(NEW),
               "--device", "cuda"]
    r_args_x = parse(rcommon)
    r_args_h = parse(rcommon + ["--lut-act", "--calib-steps", "2"])
    r_args_i = parse(rcommon + ["--lut-act", "--calib-steps", "2",
                                "--lut-sites", "all"])
    r_args_j = parse(rcommon + ["--lut-act", "--calib-steps", "2",
                                "--lut-sites", "all", "--lut-fuse"])
    t0 = time.perf_counter()
    rcfg0, rparams, rbatch, rrng = launcher.setup(r_args_x)
    torch.cuda.synchronize()
    log(f"[9] {stamp()} {rcfg0.name}: {rcfg0.n_layers} layers, d_model "
        f"{rcfg0.d_model}, {rcfg0.d_model // rcfg0.rwkv_head_dim} heads x "
        f"{rcfg0.rwkv_head_dim}, d_ff {rcfg0.d_ff}, vocab "
        f"{rcfg0.vocab_size}, {rcfg0.dtype}; "
        f"{sum(p.numel() for p in rparams.parameters()) / 1e9:.3f}G params "
        f"in {time.perf_counter() - t0:.1f}s")
    r_plans = launcher.build_plans(r_args_h, rcfg0, rparams, rrng,
                                   log=lambda m: log("    " + m))
    r_plans_all = launcher.build_plans(
        r_args_i, form_config(None, rcfg0, r_args_i), rparams, rrng,
        log=lambda m: log("    " + m))
    r_multi = r_plans_all.tables_for_model(backend="cuda", kernel="fused",
                                           device=dev)["multi"]
    k3_err, k3_ng_share = check_fused_nongated(
        dev, rparams, r_multi, r_plans.sites["ffn"].luts[0], gen)
    max_err["fused_matmul_lut"] = max(max_err["fused_matmul_lut"], k3_err)
    k4_err, k4_cases = check_multisite(dev, r_multi, gen)
    max_err["lut_act_multi"] = max(max_err["lut_act_multi"], k4_err)
    log(f"[9] K4 bit-exact on rwkv6-3b's super-slab "
        f"({r_multi['meta']['sites']}), {k4_cases} (site, layer, dtype, "
        f"launch) cases as in [4]; repeat launches, graph replays and the "
        f"refusal as in [4]")
    # layer 0's WKV inputs of a real full-width prefill
    seen = []
    orig_wkv = ssm_mod.wkv_chunked

    def record(*a, **kw):
        if not seen:
            seen.append(a)
        return orig_wkv(*a, **kw)

    ssm_mod.wkv_chunked = record
    try:
        launcher.prefill(rparams, rcfg0, rbatch, max_seq=T,
                         lut_tables=None)
    finally:
        ssm_mod.wkv_chunked = orig_wkv
    k8_cases = wkv_cases(torch, dev, gen, seen[0])
    max_err["wkv"] = check_wkv(dev, k8_cases)
    log(f"[9] {stamp()} K8 within rtol = atol = 1e-4 of its plain version "
        f"on {len(k8_cases)} cases; largest difference {max_err['wkv']:.3e}")

    # ---- 10. the serving path, rwkv6-3b (path B: forms x, h-j) -------------
    n_wkv = {"wkv": rcfg0.n_layers}   # one K8 launch per layer per prefill
    r_forms = [
        ("x", r_args_x, None, ["wkv"], None),
        ("h", r_args_h, r_plans, ["lut_act_stacked", "wkv"], "gather"),
        ("i", r_args_i, r_plans_all, ["lut_act_stacked", "wkv"], "gather"),
        ("j", r_args_j, r_plans_all,
         ["fused_matmul_lut", "lut_act_multi", "wkv"], "i"),
    ]
    for label, args, pl, uses, ref in r_forms:
        log(f"[10] {stamp()}")
        serve_form(launcher, dev, label, args, rcfg0, rparams, rbatch, pl,
                   uses, results, totals, ref=ref, want=n_wkv)
    drift = {
        "qwen e->f": logit_drift(launcher, dev, cfg0, params, batch,
                                 (args_e, plans_all), (args_f, plans_all)),
        "rwkv x->h": logit_drift(launcher, dev, rcfg0, rparams, rbatch,
                                 (r_args_x, None), (r_args_h, r_plans)),
        "rwkv i->j": logit_drift(launcher, dev, rcfg0, rparams, rbatch,
                                 (r_args_i, r_plans_all),
                                 (r_args_j, r_plans_all))}
    for k, v in drift.items():
        log(f"[10] prefill logits {k}: max |diff| {v['max_abs_diff']:.4g}, "
            f"mean {v['mean_abs_diff']:.4g}, logit std {v['logit_std']:.4g},"
            f" top-1 margins {[round(m, 4) for m in v['top1_margin']]}, "
            f"same argmax {v['same_argmax']}")
    r_logits, r_state = launcher.prefill(rparams, rcfg0, rbatch,
                                         max_seq=T, lut_tables=None)
    if r_logits.shape != (B, 1, rcfg0.vocab_size) or not torch.isfinite(
            r_logits.float()).all() or not all(
                torch.isfinite(v.float()).all() for v in r_state.values()):
        raise AssertionError(f"bad rwkv6-3b logits or state "
                             f"{tuple(r_logits.shape)}")

    # ---- 11. per-kernel times ---------------------------------------------
    log(f"[11] {stamp()}")
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
            # the served input: the gate half of the [gate|up] product, a
            # (rows, 3072) view with row stride 6144 that K1 reads in place
            x = k1_layouts(torch, rows, torch.bfloat16, dev, gen)["gate view"]
            xc = x.contiguous()
            if name == "lut_act_stacked":
                kfn = lambda: ops.lut_act_stacked(x, st, L // 2)
                cfn = lambda: ops.lut_act_stacked(xc, st, L // 2)
                pfn = lambda: lut_act_stacked_plain(x, st, L // 2)
            else:
                # the served form: an unrolled layer's entry and the record
                # built with it; "per_call_record_ms" builds it per call
                lut = plans.sites["mlp"].luts[L // 2]
                pa = lut.plan_arrays(packed=True, device=dev)
                kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi, y_lo=lut.y_lo,
                          y_hi=lut.y_hi)
                rec = plans.sites["mlp"].entry(
                    form="layers", packed=True,
                    device=dev)["layers"][L // 2]["k1_record"]
                kfn = lambda: ops.lut_act(x, pa, **kw, record=rec)
                cfn = lambda: ops.lut_act(xc, pa, **kw, record=rec)
                rfn = lambda: ops.lut_act(x, pa, **kw)
                pfn = lambda: lut_act_plain(
                    x, pa.arrays, l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb,
                    w_in=pa.w_in, w_out=pa.w_out, pack=pa.pack, **kw)
            n = x.numel()
            bms, by = bound(2 * n * 2 + slab_bytes + 20, 5 * n,
                            PEAK_F32_FLOPS)
            t = {"ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
                 "contiguous_ms": timed_ms(cfn),
                 "contiguous_graph_ms": graph_ms(cfn),
                 "plain_ms": timed_ms(pfn), "bound_ms": bms,
                 "bound_by": by, "input": "gate view, row stride 6144"}
            if name == "lut_act":
                t["per_call_record_ms"] = timed_ms(rfn)
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
             "mismatch_share_vs_plain": k3_mismatch,
             "mismatch_share_vs_plain_nongated": k3_ng_share}
    K = cfg.d_model
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        t = k3_times(x, params.blocks["w_in"], ftab(L // 2), f_slice, L // 2,
                     gated=True)
        if shape_name == "decode":
            entry.update(t)
        else:
            entry["prefill"] = t
    # rwkv6-3b's ffn site: non-gated, K 2560 x N 8960
    rws = rparams.blocks["w_ffn_k"]
    RL, RK = rws.shape[:2]
    r_slice = multi_site_stacked_entry(r_multi, "ffn")
    rtab = {"multi_entry": r_multi, "site": "ffn", "layer": RL // 2}
    entry["ffn_nongated"] = {}
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, RK, generator=gen, device=dev).to(torch.bfloat16)
        entry["ffn_nongated"][shape_name] = k3_times(
            x, rws, rtab, r_slice, RL // 2, gated=False, n=20)
    kernels.append(entry)

    # K4 at the shapes form (f) hands it, per site, in a prefill and a
    # decode step, and the decode shapes in one multi-segment launch
    f_cfg = form_config(plans_all, cfg0, args_f)
    f_tabs = launcher.serving_tables(args_f, plans_all, dev, log=quiet)
    served = served_k4_shapes(launcher, params, f_cfg, batch, f_tabs)
    log(f"[11] K4's inputs in form (f) (site: shapes): {served}")
    counts = {math.prod(sh) for step in served.values()
              for shapes in step.values() for sh in shapes}
    if not counts <= set(SERVED_K4):
        raise AssertionError(f"form (f) hands K4 counts {sorted(counts)}; "
                             f"phases 4 and 9 check only {SERVED_K4}")
    meta_bytes = 4 * (3 + 2)   # a layer's meta_i and [y_lo, span] rows

    def multi_work(xs):
        nbytes = sum(2 * x.numel() * x.element_size() for x in xs.values())
        for s in xs:
            sl = multi_site_stacked_entry(a_multi, s)
            nbytes += meta_bytes + sum(
                int(sl["arrays"][c][0].numel()) * 4 for c in sl["arrays"]
                if c != "t_lb" or sl["meta"]["any_lb"])
        return nbytes, 20 * sum(x.numel() for x in xs.values())

    entry = {"name": "lut_act_multi", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lut_act_multi.cu",
             "replaces": "src/repro/kernels/lut_act.py:279",
             "launches": totals["lut_act_multi"],
             "max_abs_err": max_err["lut_act_multi"], "library_ms": None,
             "shapes": {}}
    # the largest site first (attn_exp): its decode time heads the entry
    dshapes = dict(sorted(((s, max(sh, key=math.prod))
                           for s, sh in served["decode"].items()),
                          key=lambda kv: -math.prod(kv[1])))
    groups = {s: {s: sh} for s, sh in dshapes.items()}
    groups["multi-segment"] = dshapes
    groups.update({f"{s} prefill": {s: max(sh, key=math.prod)}
                   for s, sh in served["prefill"].items()})
    for label, group in groups.items():
        xs = {s: site_edge_inputs(torch, a_multi, s, math.prod(sh),
                                  torch.float32, dev, gen).view(sh)
              for s, sh in group.items()}
        kfn = lambda: ops.lut_act_multi(xs, a_multi, L // 2)
        yk, yp = kfn(), lut_act_multi_plain(xs, a_multi, L // 2)
        if not all(bits_equal(torch, yk[s], yp[s]) for s in xs):
            raise AssertionError(f"K4 {label}: differs from its plain "
                                 f"version at the timed inputs")
        nbytes, ops_ = multi_work(xs)
        bms, by = bound(nbytes, ops_, PEAK_F32_FLOPS)
        t = {"shape": {s: list(sh) for s, sh in group.items()},
             "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
             "plain_ms": timed_ms(
                 lambda: lut_act_multi_plain(xs, a_multi, L // 2)),
             "bound_ms": bms, "bound_by": by, "library_ms": None}
        if not entry["shapes"]:
            entry.update({k: v for k, v in t.items() if k != "shape"},
                         shape=t["shape"])
        if label == "attn_exp prefill":
            entry["prefill"] = t
        entry["shapes"][label] = t
    kernels.append(entry)

    # K8 at rwkv6-3b's prefill shape, layer 0's real inputs
    (q, k, v, lw, u), chunk, _ = k8_cases["layer-0 prefill"]
    f32 = [a.float().contiguous() for a in (q, k, v, lw, u)]
    kfn = lambda: ops.wkv(*f32, chunk=chunk)
    bsz, tt, hh, nn = q.shape
    n_chunks = -(-tt // chunk)
    cc = min(chunk, tt)
    wkv_bytes = 4 * (5 * bsz * tt * hh * nn + hh * nn + bsz * hh * nn * nn)
    f32_ops, tc_ops = k8_work(cc, nn)
    per = bsz * hh * n_chunks
    bms, by = bound(wkv_bytes, per * f32_ops, PEAK_F32_FLOPS,
                    more=[(per * tc_ops, PEAK_TF32_FLOPS)])
    entry = {"name": "wkv", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/wkv.cu",
             "replaces": "src/repro/kernels/wkv.py:68",
             "launches": totals["wkv"], "max_abs_err": max_err["wkv"],
             "shape": [bsz, tt, hh, nn, chunk], "ms": timed_ms(kfn, n=20),
             "graph_ms": graph_ms(kfn, n=20),
             "plain_ms": timed_ms(lambda: wkv_chunked_plain(
                 *f32, chunk=chunk), n=5),
             "bound_ms": bms, "bound_by": by, "library_ms": None}
    kernels.append(entry)
    for k in kernels:
        line = (f"[11] {k['name']}: {k['ms'] * 1e3:.2f} us/launch (graph "
                f"{k['graph_ms'] * 1e3:.2f} us) at {k['shape']}, bound "
                f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), plain "
                f"{k['plain_ms'] * 1e3:.2f} us; launches {k['launches']}")
        if "prefill" in k:
            line += (f"; prefill {k['prefill']['ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['graph_ms'] * 1e3:.2f}), bound "
                     f"{k['prefill']['bound_ms'] * 1e3:.3f} us, plain "
                     f"{k['prefill']['plain_ms'] * 1e3:.2f} us")
        if "contiguous_ms" in k:
            line += (f"; input {k['input']}; on a contiguous copy "
                     f"{k['contiguous_ms'] * 1e3:.2f} us (graph "
                     f"{k['contiguous_graph_ms'] * 1e3:.2f}), prefill "
                     f"{k['prefill']['contiguous_ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['contiguous_graph_ms'] * 1e3:.2f})")
        if "per_call_record_ms" in k:
            line += (f"; record built per call "
                     f"{k['per_call_record_ms'] * 1e3:.2f} us, prefill "
                     f"{k['prefill']['per_call_record_ms'] * 1e3:.2f} us")
        if k.get("library_ms") is not None:
            line += (f"; library {k['library_ms'] * 1e3:.2f} us (graph "
                     f"{k['library_graph_ms'] * 1e3:.2f}), prefill "
                     f"{k['prefill']['library_ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['library_graph_ms'] * 1e3:.2f}); "
                     f"cuBLAS alone {k['matmul_only_ms'] * 1e3:.2f} us "
                     f"(graph {k['matmul_only_graph_ms'] * 1e3:.2f})")
        log(line)
        for label, t in k.get("shapes", {}).items():
            log(f"    {label} {t['shape']}: {t['ms'] * 1e3:.2f} us (graph "
                f"{t['graph_ms'] * 1e3:.2f}), bound {t['bound_ms'] * 1e3:.3f}"
                f" us ({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us")
        for label, t in k.get("ffn_nongated", {}).items():
            log(f"    ffn non-gated {label} {t['shape']}: {t['ms'] * 1e3:.2f}"
                f" us (graph {t['graph_ms'] * 1e3:.2f}), bound "
                f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
                f"{t['plain_ms'] * 1e3:.2f} us, library (cuBLAS + K1) "
                f"{t['library_ms'] * 1e3:.2f} us (graph "
                f"{t['library_graph_ms'] * 1e3:.2f})")
    kernels += time_toolflow_kernels(dev, flow, errors)

    # ---- 12. where a decode step's time goes -------------------------------
    log(f"[12] {stamp()}")
    r_tables_j = launcher.serving_tables(r_args_j, r_plans_all, dev,
                                         log=quiet)
    steps = {}
    for label, scfg, sparams, sbatch, stab in (
            ("exact", cfg0, params, batch, None),
            ("a", cfg, params, batch, st_cuda),
            ("d", dataclasses.replace(cfg, lut_fuse=True), params, batch,
             f_tables),
            ("f", f_cfg, params, batch, f_tabs),
            ("rwkv exact", rcfg0, rparams, rbatch, None),
            ("rwkv j", form_config(r_plans_all, rcfg0, r_args_j), rparams,
             rbatch, r_tables_j)):
        steps[label] = profile_decode_step(launcher, label, scfg, sparams,
                                           sbatch, stab)

    # K1 reads the gate half in place: form (a) launches what the exact
    # activation does (one kernel for the activation, one for the product)
    if (steps["a"]["kernels"], steps["a"]["copy_kernels"]) != (
            steps["exact"]["kernels"], steps["exact"]["copy_kernels"]):
        raise AssertionError(
            f"decode step (a) launched {steps['a']['kernels']} kernels "
            f"({steps['a']['copy_kernels']} copies), the exact step "
            f"{steps['exact']['kernels']} ({steps['exact']['copy_kernels']})")
    log(f"[12] form (a) launches as many kernels per step as the exact "
        f"model, copies included: K1 takes the gate view without a copy")
    if not steps["f"]["launches"].get("lut_act_multi"):
        raise AssertionError(f"form (f)'s decode step launched no K4: "
                             f"{steps['f']['launches']}")

    # ---- 15. the moe family, after the others (their models freed first)
    log(f"[15] {stamp()}")
    del (params, rparams, sparams, s_params, cases, w_in, rws, st, stacks)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] after freeing the earlier models: "
        f"{torch.cuda.memory_allocated(dev)} bytes allocated; the largest "
        f"live storages (bytes, a tensor's shape): {largest_storages()}")
    moe_totals = {k: 0 for k in launch_counts()}
    moe = {}
    for arch in MOE_FORMS:
        moe[arch] = run_moe_model(launcher, dev, arch, moe_totals, results,
                                  stamp)
        gc.collect()
        torch.cuda.empty_cache()
    # the kernels' launches on the main path include phase 15's forms; the
    # moe shapes join their entries
    for k in kernels:
        k["launches"] += moe_totals.get(k["name"], 0)
        shapes = {f"{t['name']} {t['site']} {t['step']}": {
            f: t[f] for f in t if f not in ("name", "kernel")}
            for r in moe.values() for t in r["lut_calls"]
            if t["kernel"] == k["name"]}
        if shapes:
            k["moe"] = shapes
        if k["name"] == "fused_matmul_lut":
            k["shared_expert"] = {
                n: v for n, v in moe["deepseek-moe-16b"]["shared_k3"].items()
                if n != "mismatch_share_vs_plain"}
    log(f"[15] phase 15's launches: {moe_totals}")

    summary = {"card": smi, "seconds": time.perf_counter() - t_start,
               "exact": exact, "steps": steps, "logit_drift": drift,
               "batcher": batcher, "moe": moe,
               "forms": {
                   f: {k: v for k, v in r.items() if k != "plans"}
                   for f, r in results.items()}, "kernels": kernels,
               "toolflow": dict(flow, flows={
                   m: dict({k: v for k, v in f.items()
                            if k not in ("plan_list", "k7_calls")},
                           k7_calls=[[*k, c] for k, (_, c) in sorted(
                               f["k7_calls"].items())])
                   for m, f in flow["flows"].items()})}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"done in {time.perf_counter() - t_start:.0f}s")
    # four significant digits and no spaces keep this line short (about
    # 21 KB); chip_smoke.json keeps every digit
    print(json.dumps({"kernels": sig4(kernels)}, separators=(",", ":")),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
