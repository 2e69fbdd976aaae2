"""The port's mesh and placement rules against the reference's
(``repro.nn.sharding``, ``repro.launch.mesh``, ``repro.serve.sharded``),
with no process group: axis resolution and the divisibility fallback,
the mesh helpers' checks, the table placement report on the same tables,
the decode state's axes, the parameters' axes, and the launcher's mesh
refusals."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import calibration_from_capture as j_from_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.nn import sharding as jsh
from repro.nn.transformer import param_defs as j_param_defs
from repro.serve import build_serving_plans as j_build
from repro.serve import sharded as jsd
from repro_torch import configs as tconfigs
from repro_torch.calib import CalibrationSet
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launcher
from repro_torch.nn import sharding as tsh
from repro_torch.nn.transformer import _flat_defs, param_defs
from repro_torch.serve import build_serving_plans, sharded as tsd
from repro_torch.serve.kvcache import init_cache, state_leaves

ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "phi-3-vision-4.2b",
         "rwkv6-3b", "recurrentgemma-9b", "whisper-small")


class StandIn:
    """What the reference's rules read of a jax ``Mesh``: its axis names
    and its ``shape`` mapping."""

    def __init__(self, axes, sizes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))


MESHES = [(("data", "model"), (2, 2)), (("data", "model"), (4, 2)),
          (("data", "model"), (2, 1)), (("pod", "data", "model"), (2, 2, 2)),
          (("data",), (4,)), (("model",), (2,))]


@pytest.mark.parametrize("axes,sizes", MESHES)
def test_resolve_axis_and_spec_equal_reference(axes, sizes):
    ref, mine = StandIn(axes, sizes), tsh.Mesh(axes, sizes)
    for logical in ("dp", "tp", "fsdp", "sp", None):
        assert tsh.resolve_axis(logical, mine) == jsh.resolve_axis(
            logical, ref), logical
    for bad in ("xp", "batch"):
        with pytest.raises(ValueError, match="unknown logical axis"):
            tsh.resolve_axis(bad, mine)
        with pytest.raises(ValueError, match="unknown logical axis"):
            jsh.resolve_axis(bad, ref)
    assert tsh.resolve_axis("tp", None) is None


@pytest.mark.parametrize("axes,sizes", MESHES)
def test_divisibility_fallback_equals_reference(axes, sizes):
    """A dim the resolved axes' product does not divide is replicated: 24
    heads on a model axis of 16 (here 3 on 2), the batch on the data
    axes."""
    ref, mine = StandIn(axes, sizes), tsh.Mesh(axes, sizes)
    for shape in [(4, 6), (3, 8), (5, 5), (8, 3), (1, 2)]:
        for logical in [("dp", "tp"), ("tp", "dp"), ("fsdp", None),
                        (None, "tp")]:
            want = []
            for dim, a in zip(shape, logical):
                r = jsh.resolve_axis(a, ref)
                want.append(r if jsh._divisible(dim, ref, r) else None)
            got = tsh.named_sharding(mine, *logical, shape=shape).spec
            assert got == tuple(want), (shape, logical)
            for dim, a in zip(shape, logical):
                r = jsh.resolve_axis(a, ref)
                assert tsh._divisible(dim, mine, r) == jsh._divisible(
                    dim, ref, r)


def test_mesh_layout_is_row_major():
    """Rank r of a (data, model) mesh sits at (r // tp, r % tp), the order
    of jax.make_mesh's devices; the model-axis peers of rank 5 on 4x2 are
    4 and 5, its data-axis peers 1, 3, 5 and 7."""
    m = tsh.Mesh(("data", "model"), (4, 2), rank=5)
    assert m.coords() == {"data": 2, "model": 1}
    assert m.members("model") == [4, 5]
    assert m.members("data") == [1, 3, 5, 7]
    assert m.size == 8 and m.shape == {"data": 4, "model": 2}
    p = tsh.Mesh(("pod", "data", "model"), (2, 2, 2), rank=6)
    assert p.coords() == {"pod": 1, "data": 1, "model": 0}
    # the batch over (pod, data): block pod * 2 + data
    pl = tsh.named_sharding(p, "dp", None, shape=(8, 3))
    x = torch.arange(24).reshape(8, 3)
    assert torch.equal(pl.local(x), x[6:8])
    with pytest.raises(RuntimeError, match="layout only"):
        tsh.Mesh(("data",), (2,)).group("data")


def test_make_host_mesh_checks_and_mesh_or_none():
    for bad in ((0, 1), (1, -2)):
        with pytest.raises(ValueError, match=">= 1"):
            tmesh.make_host_mesh(*bad)
    # no process group here: one rank runs
    with pytest.raises(ValueError, match="needs 4 ranks but 1 are running"):
        tmesh.make_host_mesh(2, 2)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.mesh_or_none(2, 2)
    assert tmesh.mesh_or_none(1, 1) is None
    assert tmesh.mesh_or_none(0, 1) is None   # as the reference's
    one = tmesh.make_host_mesh(1, 1)
    assert one.shape == {"data": 1, "model": 1} and one.rank == 0
    with pytest.raises(ValueError, match="256 ranks needed"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks needed"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.run_ranks(print, dp=0, tp=2, device="cpu")


@pytest.mark.parametrize("dev,world,cards,want", [
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 4, 1, "gloo"),
    ("cuda", 8, 4, "gloo"), ("cpu", 4, 0, "gloo"), ("cpu", 1, 8, "gloo")])
def test_backend_follows_the_layout(dev, world, cards, want):
    """NCCL when every rank has its own card, gloo where ranks share one
    (NCCL refuses two ranks on a device) and on the CPU."""
    assert tmesh.choose_backend(dev, world, cards) == want


def test_rank_device_round_robin():
    assert tmesh.rank_device(3, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.rank_device(0, "cuda")


# -------------------------------------------------------------------------
# table placement against the reference on the same tables
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both_plans():
    """Per-site plans of qwen3-0.6b's f32 smoke config from one
    reference capture: the reference's and the port's."""
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32", lut_sites="all")
    cj = dataclasses.replace(cj, lut_sites="all")
    pj = j_init(cj, jax.random.PRNGKey(0))
    cap = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2, seq_len=8,
                                            seed=1))
    cal = j_from_capture(cap)
    calt = CalibrationSet(masks=cal.masks, w_in=cal.w_in, x_lo=cal.x_lo,
                          x_hi=cal.x_hi, hists=cal.hists, ranges=cal.ranges)
    return j_build(cj, cal), build_serving_plans(ct, calt)


@pytest.mark.parametrize("backends", [("gather", "gather"),
                                      ("pallas", "cuda")])
@pytest.mark.parametrize("plan_exec", ["stacked", "unrolled"])
def test_placement_report_equals_reference(both_plans, backends, plan_exec):
    """``plan_placement_report`` gives the reference's sites, placements
    and byte counts on meshes 2x1, 2x2 and 4x2 at thresholds 0, the
    default and 1 << 62 (the shard_map mode's), but for what a rank holds
    of a layer-sharded slab: the port keeps the full-size buffer K1 reads
    beside the rank's share, so a rank holds the slab's bytes more than
    the reference's count."""
    pj, pt = both_plans
    tj = pj.tables_for_model(backend=backends[0], plan_exec=plan_exec,
                             mesh=False)
    tt = pt.tables_for_model(backend=backends[1], plan_exec=plan_exec,
                             device="cpu")
    seen = set()
    for sizes in ((2, 1), (2, 2), (4, 2)):
        ref = StandIn(("data", "model"), sizes)
        mine = tsh.Mesh(("data", "model"), sizes)
        for thr in (0, None, 1 << 62):
            kw = {} if thr is None else {"shard_threshold_bytes": thr}
            want = jsd.plan_placement_report(tj, ref,
                                             jsd.PlacementPolicy(**kw))
            for site in want["sites"].values():
                if site["placement"] == "layer_sharded":
                    site["per_device_bytes"] += site["bytes"]
            want["per_device_bytes"] += want["sharded_bytes"]
            got = tsd.plan_placement_report(tt, mine,
                                            tsd.PlacementPolicy(**kw))
            assert got == want, (sizes, thr)
            seen |= {s["placement"] for s in got["sites"].values()}
    assert seen == ({"replicated", "layer_sharded"} if plan_exec ==
                    "stacked" else {"replicated"})


def test_fused_tables_refused_under_a_mesh(both_plans):
    """K4's super-slab is the single-device fast path: under a mesh the
    plans still offer it, and the placement refuses it."""
    _, pt = both_plans
    mesh = tsh.Mesh(("data", "model"), (2, 2))
    assert pt.fused_available()
    fused = pt.tables_for_model(backend="gather", kernel="fused",
                                device="cpu")
    with pytest.raises(ValueError, match="single-device fast path"):
        tsd.place_tables(fused, mesh)
    with pytest.raises(ValueError, match="single-device fast path"):
        pt.tables_for_model(backend="gather", kernel="fused", device="cpu",
                            mesh=mesh)


@pytest.mark.parametrize("backends,error", [
    ((), "non-empty subset"), (("pallas",), "non-empty subset"),
    (("gather", "cuda"), "needs tensors on the card")])
def test_backend_equivalence_names_its_backends(both_plans, backends, error):
    """The backends are an argument: an unknown or empty set is refused,
    and on the CPU the default pair raises at the ``cuda`` backend rather
    than holding ``gather`` against itself."""
    from repro_torch.nn import init_params
    from repro_torch.serve import verify_backend_equivalence

    _, pt = both_plans
    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    params = init_params(cfg, 0, "cpu")
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 4))
    with pytest.raises(ValueError, match=error):
        verify_backend_equivalence(cfg, params, pt, prompt, 1,
                                   backends=backends)


def test_placement_report_without_tables():
    empty = {"sites": {}, "replicated_bytes": 0, "sharded_bytes": 0,
             "per_device_bytes": 0}
    assert tsd.plan_placement_report(None, tsh.Mesh(("data",), (2,))) \
        == empty == jsd.plan_placement_report(None, StandIn(("data",), (2,)))


# -------------------------------------------------------------------------
# decode state and parameters
# -------------------------------------------------------------------------
class _Key:
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cache_axes_equal_reference_state_axes(arch, kv_dtype):
    """Every leaf of every family's decode state gets the reference's
    ``_state_axes`` (batch over dp only), and ``serve_cache_shardings``
    resolves them with the divisibility fallback."""
    cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    state = init_cache(cfg, 4, 16, device="meta",
                       kv_dtype="int8" if kv_dtype == "int8" else None)
    mesh = tsh.Mesh(("data", "model"), (2, 2))
    placed = dict(state_leaves(tsd.serve_cache_shardings(
        cfg, mesh, 4, 16, kv_dtype)))
    leaves = list(state_leaves(state))
    assert leaves and sorted(placed) == sorted(n for n, _ in leaves)
    for name, leaf in leaves:
        want = jsd._state_axes((_Key(name.rsplit(".", 1)[-1]),), leaf)
        got = tsd._state_axes(name.rsplit(".", 1)[-1], leaf.dim())
        assert got == want, name
        spec = tsh.named_sharding(mesh, *got, shape=tuple(leaf.shape)).spec
        assert placed[name].spec == spec
        if "dp" in got:
            assert ("data",) in spec, name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_reference(arch):
    """Every parameter leaf carries the reference's logical axes, and its
    at-rest placement keeps every "tp" axis the model axis divides."""
    cj = jconfigs.smoke_config(jconfigs.get_config(arch))
    ct = tconfigs.smoke_config(tconfigs.get_config(arch))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    ref = flat(j_param_defs(cj))
    mine = {n: d for n, d, _ in _flat_defs(param_defs(ct))}
    assert sorted(ref) == sorted(mine)
    mesh = tsh.Mesh(("data", "model"), (2, 2))
    placed = tsd.serve_param_shardings(ct, mesh)
    for name, d in mine.items():
        axes = d.axes or (None,) * len(d.shape)
        assert tuple(axes) == tuple(ref[name].axes), name
        assert d.shape == ref[name].shape
        want = tuple("model" if a == "tp" and n % 2 == 0 else None
                     for a, n in zip(axes, d.shape))
        assert placed[name].spec == want, name


def test_param_shares_cut_from_full_and_drawn_alone():
    """``init_params_sharded`` draws the single-device bits: on a layout
    mesh at each model rank, the shares of every leaf equal the cut of
    ``init_params``' full tensors, and the expert stacks hold E / tp
    experts."""
    from repro_torch.nn import init_params

    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("deepseek-moe-16b")),
        dtype="float32")
    full = dict(init_params(cfg, 0, "cpu").named_parameters())
    for rank in range(2):
        mesh = tsh.Mesh(("data", "model"), (1, 2), rank=rank)
        mine = dict(tsd.init_params_sharded(cfg, 0, mesh, "cpu")
                    .named_parameters())
        pl = tsd.serve_param_shardings(cfg, mesh)
        for name, t in full.items():
            assert torch.equal(mine[name], pl[name].local(t)), name
        e = cfg.moe.n_experts
        assert mine["blocks.moe_w_in"].shape[1] == e // 2
        lo = rank * e // 2
        assert torch.equal(mine["blocks.moe_w_in"],
                           full["blocks.moe_w_in"][:, lo:lo + e // 2])


# -------------------------------------------------------------------------
# the launcher's mesh refusals (the reference's words)
# -------------------------------------------------------------------------
BASE = ["--arch", "qwen3-0.6b", "--device", "cpu", "--lut-act"]


@pytest.mark.parametrize("extra,words", [
    (["--mesh", "2,2", "--mesh-mode", "shard_map", "--kv-int8"],
     "--kv-int8 prefill replay is served in gspmd mesh mode only"),
    (["--mesh", "2,2", "--lut-fuse"],
     "--lut-fuse is the single-device fast path — drop --mesh"),
    (["--mesh", "1,2", "--reload-plan", "x.npz"],
     "--reload-plan is single-device"),
    (["--mesh", "2x2"], "--mesh expects DP,TP (e.g. 2,2), got '2x2'"),
    (["--mesh", "0,2"], "dp and tp must be >= 1"),
])
def test_launcher_mesh_refusals(extra, words, capsys):
    with pytest.raises(SystemExit) as info:
        launcher.main(BASE + extra)
    assert info.value.code == 2
    assert words in capsys.readouterr().err


def test_launcher_mesh_without_a_card_raises(capsys):
    """``--mesh`` on the card's default device, with no card: a parser
    error before any rank starts, never a mesh on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "qwen3-0.6b", "--mesh", "2,2"])
    assert "CUDA is not available" in capsys.readouterr().err
