"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline`` on the CPU: ``model_flops_per_step`` for every
architecture and kind, ``RooflineTerms``' keys and dominance, the cost
counter (a Python loop counted once an iteration, views free, the kernels'
cost points, collectives by kind on two gloo ranks), the smoke train and
decode steps' matmul FLOPs against the reference's ``analyze_compiled``,
and both packages' ``report`` on one port JSON.

The FLOPs of a step are held within 1% of the reference's HLO dots (on
the CPU they are equal).  The two count the same products (the
projections, the attention's score and value contractions, the logits;
the backward's two products for each forward one, the recomputed forward
under ``remat``), each as ``2 x out x contraction``; the port's side is
the card's program (traced on the meta device).  rwkv6-3b's training step
is held on its products outside the WKV: the reference's WKV is jnp dots
(its chunked form and their gradients), the port's K8 and K8b are
hand-written kernels, priced as kernel points with no FLOPs, as the
reference prices a Pallas call; its totals are 0.89 of the reference's
at the smoke shape.  The numbers the test prints are the evidence.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import roofline as jroof
from repro.configs import ARCH_NAMES as J_ARCHS
from repro.configs import get_config as j_get_config
from repro_torch import roofline as troof
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.roofline.costs import count_costs

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", J_ARCHS)
def test_model_flops_equal_reference(arch):
    for kind, (b, t) in (("train", (256, 4096)), ("prefill", (32, 32768)),
                         ("decode", (128, 32768))):
        assert troof.model_flops_per_step(t_get_config(arch), b, t, kind) \
            == jroof.model_flops_per_step(j_get_config(arch), b, t, kind)


def test_terms_keys_and_dominance():
    kw = dict(flops=3e12, hbm_bytes=5e9, coll_bytes=7e8,
              per_op_coll={"all-reduce": 7e8})
    t, j = troof.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    assert list(t.as_dict()) == list(j.as_dict())
    t = troof.RooflineTerms(flops=troof.PEAK_FLOPS, hbm_bytes=1e9,
                            coll_bytes=0, per_op_coll={})
    assert t.compute_s == 1.0 and t.dominant == "compute"
    assert t.bound_s == 1.0
    t2 = troof.RooflineTerms(flops=1e9, hbm_bytes=troof.HBM_BW * 2,
                             coll_bytes=0, per_op_coll={})
    assert t2.dominant == "memory" and t2.memory_s == 2.0
    t3 = troof.RooflineTerms(flops=1e9, hbm_bytes=1e9,
                             coll_bytes=troof.ICI_BW * 3, per_op_coll={})
    assert t3.dominant == "collective" and t3.bound_s == 3.0


def test_h100_constants():
    """The H100 SXM5 peaks ``chip_smoke.py`` bounds its kernels by."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.ICI_BW) == (
        989e12, 3.35e12, 450e9)
    assert (troof.PEAK_TF32_FLOPS, troof.PEAK_F32_FLOPS) == (495e12, 67e12)


def test_loop_counted_each_iteration_and_views_free():
    """The counterpart of ``test_loop_multipliers_and_costs``: a Python
    loop of N products counts N times, with no multiplier; views,
    reshapes and ``detach`` are free."""
    x = torch.randn(8, 128)
    w = torch.randn(128, 128)
    n = 12
    with count_costs() as c:
        h = x
        for _ in range(n):
            h = (h @ w).view(8, 2, 64).reshape(8, 128).detach()
    assert c.flops == 2 * 8 * 128 * 128 * n
    assert c.per_comp_flops == {"aten.mm": c.flops}
    # each product reads its two operands and writes its result
    assert c.hbm_bytes == n * 4 * (8 * 128 + 128 * 128 + 8 * 128)
    assert set(c.per_comp_hbm) == {"aten.mm"}
    assert c.n_ops == n and c.launches == {} and c.coll_bytes == 0


def test_broadcast_operand_read_once_and_device_filter():
    x = torch.randn(4, 1).expand(4, 1000)
    with count_costs() as c:
        torch.sin(x)
    assert c.hbm_bytes == 4 * (4 + 4 * 1000)
    with count_costs(device="meta") as c2:
        torch.sin(x)
    assert c2.hbm_bytes == 0 and c2.n_ops == 0


def test_kernel_cost_points_on_the_abstract_route():
    """Inside ``ops.abstract()`` a wrapper on the card's stand-in notes its
    launch into the counter (operands, result, one layer's tables) and
    returns an empty result of the kernel's shape; its own launch count
    stays.  K3 adds its product's FLOPs."""
    from repro_torch.kernels import launch_counts, ops
    from repro_torch.serve import build_serving_plans

    cfg = t_smoke(t_get_config("qwen3-0.6b"))
    plans = build_serving_plans(cfg, np.random.default_rng(0).normal(
        size=20000) * 3)
    before = launch_counts()
    with ops.abstract():
        tables = plans.tables_for_model(backend="cuda", device="meta")
        entry = tables["sites"]["mlp"]
        x = torch.empty((3, 5, 64), dtype=torch.bfloat16, device="meta")
        w = torch.empty((64, 96), dtype=torch.bfloat16, device="meta")
        pa = ops.PlanArrays(kind="decomposed", **{
            k: entry["meta"][k] for k in ("w_in", "w_out", "l", "w_lb",
                                          "w_hb")},
            arrays=entry["arrays"], pack=entry["meta"].get("pack"))
        with count_costs("meta") as c:
            y = ops.lut_act(x, pa, x_lo=-8.0, x_hi=8.0, y_lo=0.0, y_hi=1.0,
                            record=entry["k1_record"])
            z = ops.fused_matmul_lut(x, w, entry, gated=True)
    assert y.shape == x.shape and y.dtype == x.dtype and y.device == x.device
    assert z.shape == (3, 5, 48)
    assert c.launches == {"cuda:lut_act": 1, "cuda:fused_matmul_lut": 1}
    table = entry["k1_record"].layer_bytes
    assert table == sum(a.numel() * 4 for a in entry["arrays"].values())
    assert c.per_comp_hbm["cuda:lut_act"] == 2 * x.numel() * 2 + table
    assert c.per_comp_flops == {"cuda:fused_matmul_lut": 2 * 15 * 96 * 64}
    assert launch_counts() == before


def _collective_rank(mesh):
    from repro_torch.nn import sharding as sh

    t = torch.arange(6, dtype=torch.float32) + 10 * mesh.rank
    with count_costs() as c:
        g = sh.gather(t, mesh, "data")
        sh.all_reduce(t.clone(), mesh, "data")
        sh.broadcast(t.clone(), mesh, "data", 1)
        got = [m.clone() for m in sh.each_member(t, mesh, ("data",))]
        sh.all_reduce(t.clone(), mesh, "model")   # one rank: nothing sent
    return (g.tolist(), [m.tolist() for m in got], dict(c.per_op_coll),
            c.coll_bytes)


def test_collectives_counted_by_kind_on_two_gloo_ranks():
    """What a rank sends, by kind: a gather is one broadcast a member (2 x
    24 bytes) filed under all-gather, an all-reduce counts twice (the
    reference's ring convention), each member's broadcast once."""
    from repro_torch.launch.mesh import run_ranks

    out = run_ranks(_collective_rank, dp=2, tp=1, device="cpu")
    for g, members, coll, total in out:
        assert g == [float(v) for v in list(range(6))
                     + list(range(10, 16))]
        assert members == [list(map(float, range(6))),
                           list(map(float, range(10, 16)))]
        assert coll == {"all-gather": 48, "all-reduce": 48,
                        "broadcast": 24 + 48}
        assert total == 48 + 48 + 72


_REF_FLOPS = """
import dataclasses, json, math, sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.nn.transformer import init_params
from repro.roofline import analyze_compiled
from repro.roofline.hlo_costs import (_CONTRACT_RE, _shape_info, analyze_hlo,
                                      parse_hlo)
from repro.serve.kvcache import cache_specs
from repro.train import TrainConfig, init_train_state
from repro.train.step import (input_batch_specs, make_serve_step,
                              make_train_step)


def flops_2d(text):
    # the products of 2-D operands (the WKV's are batched), each at its
    # computation's trip multiplier
    per_comp = analyze_hlo(text).per_comp_flops
    total = 0.0
    for name, comp in parse_hlo(text)[0].items():
        raw = raw2 = 0.0
        for op in comp.ops:
            if op.opcode != "dot":
                continue
            _, (ls,) = _shape_info(comp.shapes[op.operands[0]])
            _, (rs,) = _shape_info(comp.shapes[op.operands[1]])
            _, (os_,) = _shape_info(op.type_str)
            cd = [int(x) for x in _CONTRACT_RE.search(
                op.rest).group(1).split(",") if x]
            f = 2.0 * math.prod(os_) * math.prod(ls[i] for i in cd)
            raw += f
            raw2 += f if len(ls) == len(rs) == 2 else 0.0
        if raw:
            total += raw2 * per_comp.get(name, 0.0) / raw
    return total


out = {}
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
for arch in ("qwen3-0.6b", "rwkv6-3b"):
    cfg = dataclasses.replace(
        configs.smoke_config(configs.get_config(arch)), dtype="float32")
    for remat in (False, True):
        tcfg = TrainConfig(remat=remat)
        _, jit_step, _ = make_train_step(cfg, tcfg, mesh)
        specs = input_batch_specs(cfg, 4, 64)
        state = jax.eval_shape(lambda: init_train_state(cfg, tcfg))
        text = jit_step(specs).lower(state, specs).compile().as_text()
        # analyze_compiled(c) is analyze_hlo(c.as_text())
        out[f"{arch} train remat={remat}"] = analyze_hlo(text).flops
        out[f"{arch} train remat={remat} 2-D"] = flops_2d(text)
    _, jit_dec = make_serve_step(cfg, mesh)
    params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
    comp = jit_dec(4, 64).lower(
        params, cache_specs(cfg, 4, 64),
        jax.ShapeDtypeStruct((4, 1), np.int32),
        jax.ShapeDtypeStruct((), np.int32)).compile()
    out[f"{arch} decode"] = analyze_compiled(comp).flops
print("FLOPS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_FLOPS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("FLOPS ")][-1]
    return json.loads(line[6:])


def _port_flops(arch: str, what: str):
    """The card's program traced (the meta device)."""
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(t_smoke(t_get_config(arch)), dtype="float32")
    if what == "decode":
        tr = trace_step(cfg, "decode", 4, 64)
    else:
        tr = trace_step(cfg, "train", 4, 64,
                        tcfg=TrainConfig(remat=what.endswith("True")))
    return tr["costs"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
@pytest.mark.parametrize("what", ["train remat=False", "train remat=True",
                                  "decode"])
def test_step_flops_against_reference_hlo(ref_flops, arch, what):
    """Equal within 1%; for rwkv6-3b's training step, the products outside
    the WKV (2-D on both sides; module docstring)."""
    want = ref_flops[f"{arch} {what}"]
    costs = _port_flops(arch, what)
    got = costs.flops
    print(f"{arch} {what}: port {got:.6g}, reference HLO {want:.6g}, "
          f"ratio {got / want:.6f}")
    if arch == "rwkv6-3b" and what.startswith("train"):
        want = ref_flops[f"{arch} {what} 2-D"]
        got = costs.per_comp_flops["aten.mm"]
        print(f"  2-D products: port {got:.6g}, reference {want:.6g}")
    assert abs(got - want) <= 0.01 * want


def test_reports_render_the_same_markdown(tmp_path, monkeypatch):
    """One port JSON (a smoke cell on a fake 2x2 group, renamed into the
    reference's single-pod mesh so that its roofline table shows it)
    renders to the same markdown in both packages, the reference's
    constant set to the H100's for the test."""
    from repro.roofline import report as jreport
    from repro_torch.launch.dryrun import SHAPES, dryrun_cell
    from repro_torch.roofline import report as treport

    cfg = t_smoke(t_get_config("qwen3-0.6b"))
    cell = dryrun_cell("qwen3-0.6b", "decode_32k", False, quiet=True,
                       cfg=cfg, info=dict(SHAPES["decode_32k"], seq=64,
                                          batch=4),
                       mesh_shape=(2, 2))
    assert cell["status"] == "ok", cell.get("trace")
    for mesh in ("16x16", "2x16x16"):
        (tmp_path / f"c_{mesh}.json").write_text(json.dumps(
            dict(cell, mesh=mesh)))
    skipped = {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
               "kind": "decode", "status": "skipped", "reason": "why"}
    (tmp_path / "s.json").write_text(json.dumps(skipped))
    monkeypatch.setattr(jreport, "PEAK_FLOPS", troof.PEAK_FLOPS)
    cells_t, cells_j = treport.load(str(tmp_path)), jreport.load(str(tmp_path))
    assert cells_t == cells_j
    for mesh in ("16x16", "2x16x16"):
        assert treport.dryrun_table(cells_t, mesh) == \
            jreport.dryrun_table(cells_j, mesh)
    assert treport.roofline_table(cells_t) == jreport.roofline_table(cells_j)
    assert "**" in treport.roofline_table(cells_t)
