"""Every LUT site of the port against the JAX reference (CPU): the plain
multi-site kernel (K4's plain version), greedy decode of the float32
qwen3-0.6b smoke config under ``lut_sites="all"`` (with the fused
super-slab and with the logit softcap), the calibration masks of every
site, and the launcher's site flags.

Tolerances: the plain K4 is bit-equal to the reference's multi-site Pallas
kernel run in interpret mode (integer table arithmetic and host-rounded
f32 constants: nothing to round differently).  Decode: the two frameworks
sum matmuls, norms and softmax in other orders, so an input within ~1e-6
of a quantizer bin edge may land one output level away; logits agree
within ``LUT_ATOL`` and greedy tokens must be identical.  Calibration
histograms may move a sample across a bin edge for the same reason (at
most ``HIST_MOVE_FRAC`` of a key's samples).
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import calibration_from_capture as j_from_capture
from repro.calib import capture_calibration as j_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import synthetic_batches as j_batches
from repro.kernels.ops import lut_act_multi as j_lut_act_multi
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro.serve.plans import _greedy_decode as j_greedy
from repro.serve.stacked import MultiSiteSlabs as JMultiSiteSlabs
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import calibration_from_capture as t_from_capture
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.kernels import launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels.lut_act import lut_act_multi_plain
from repro_torch.launch import serve as launcher
from repro_torch.serve import decode_step, prefill
from repro_torch.serve.stacked import MultiSiteSlabs as TMultiSiteSlabs

B, T, NEW = 2, 16, 4
LUT_ATOL = 5e-4
HIST_MOVE_FRAC = 0.01
ALL_SITES = ["attn_exp", "mlp", "norm_rsqrt", "rope_table"]


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(**kw):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32", lut_sites="all", **kw)
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32", lut_sites="all", **kw)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


@pytest.fixture(scope="module")
def setup():
    cj, ct = _cfgs()
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(0).integers(1, cj.vocab_size, (B, T),
                                               dtype=np.int32)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    plans = j_build(cj, calib)
    return cj, ct, pj, pt, tokens, plans


@pytest.fixture(scope="module")
def superslab():
    """The reference's super-slab of the all-sites plans (w_in 8, w_out
    8, as the reference's own multi-site test builds it)."""
    cj, _ = _cfgs()
    pj = j_init(cj, jax.random.PRNGKey(0))
    calib = j_capture(pj, cj, j_batches(cj, 1, batch_size=2, seq_len=8,
                                        seed=1), w_in=8)
    plans = j_build(cj, calib, w_out=8, backend="pallas")
    stacks = {k: sp.stacked() for k, sp in plans.sites.items()
              if sp.per_layer}
    ms = JMultiSiteSlabs.from_stacks(stacks)
    return ms, stacks


def _site_inputs(meta, rng, rows):
    """Each site's quantizer edges and grid points +-1 f32 ulp, then
    uniform draws across (and a little beyond) its domain."""
    xs = {}
    for i, site in enumerate(meta["sites"]):
        sm = meta["site_meta"][site]
        lo, hi, levels = sm["x_lo"], sm["x_hi"], (1 << sm["w_in"]) - 1
        k = np.arange(levels + 1, dtype=np.float64)
        grid = lo + np.concatenate([k[:-1] + 0.5, k]) / levels * (hi - lo)
        g32 = grid.astype(np.float32)
        edges = np.concatenate([np.nextafter(g32, -np.inf), g32,
                                np.nextafter(g32, np.inf)])
        n = rows[i % len(rows)] * 64
        span = hi - lo
        x = rng.uniform(lo - 0.05 * span, hi + 0.05 * span, n)
        x = x.astype(np.float32)
        m = min(n, edges.size)
        x[:m] = edges[rng.permutation(edges.size)[:m]]
        xs[site] = x.reshape(rows[i % len(rows)], 64)
    return xs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_plain_matches_reference_kernel(superslab, dtype):
    """Plain K4 == the reference's ``lut_act_multi`` (interpret) on the
    reference's super-slab carried across by ``tables_from_jax``, for
    every layer and every per-layer site with different row counts."""
    ms, _ = superslab
    entry_j = ms.entry()
    entry_t = tables_from_jax(to_np(entry_j), device="cpu")
    assert sorted(entry_t["meta"]["sites"]) == ALL_SITES
    xs = _site_inputs(entry_t["meta"], np.random.default_rng(7),
                      rows=[3, 5, 2, 7])
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    xs_j = {s: jnp.asarray(x).astype(jd) for s, x in xs.items()}
    xs_t = {s: torch.from_numpy(x).to(td) for s, x in xs.items()}
    before = launch_counts()["lut_act_multi"]
    for layer in range(ms.n_layers):
        ref = j_lut_act_multi(xs_j, entry_j, layer)
        got = tops.lut_act_multi(xs_t, entry_t, layer)
        assert set(got) == set(xs)
        for site in xs:
            r = np.asarray(ref[site].astype(jnp.float32))
            g = got[site].float().numpy()
            assert got[site].dtype == td and g.shape == r.shape
            np.testing.assert_array_equal(g, r, err_msg=f"{site} L{layer}")
    # CPU tensors go to the plain version: no launch is counted
    assert launch_counts()["lut_act_multi"] == before


def _port_stacks(stacks_j) -> dict:
    """The port's ``StackedPlanArrays`` of the reference's site stacks."""
    from repro_torch.serve.stacked import StackedPlanArrays

    return {site: StackedPlanArrays(
                n_layers=st.n_layers, w_in=st.w_in, w_out=st.w_out,
                x_lo=st.x_lo, x_hi=st.x_hi, any_lb=st.any_lb,
                arrays={c: np.array(a) for c, a in st.arrays.items()},
                meta_i=np.array(st.meta_i), meta_f=np.array(st.meta_f),
                lens=dict(st.lens))
            for site, st in stacks_j.items()}


def test_multi_plain_equals_per_site_stacked(superslab):
    """Each site of the plain K4 equals the plain K1 on that site's own
    packed stack (the port's super-slab, built from the reference's
    stacks)."""
    from repro_torch.kernels.lut_act import lut_act_stacked_plain

    _, stacks_j = superslab
    stacks_t = _port_stacks(stacks_j)
    entry = TMultiSiteSlabs.from_stacks(stacks_t).entry(device="cpu")
    xs = {s: torch.from_numpy(x) for s, x in _site_inputs(
        entry["meta"], np.random.default_rng(3), rows=[4, 1, 6]).items()}
    for layer in range(entry["meta"]["n_layers"]):
        ys = lut_act_multi_plain(xs, entry, layer)
        for site, x in xs.items():
            own = stacks_t[site].entry(packed=True, device="cpu")
            ref = lut_act_stacked_plain(x, own, layer)
            assert torch.equal(ys[site].view(torch.int32),
                               ref.view(torch.int32)), (site, layer)


def test_multi_launch_arguments(superslab):
    """The host side of a K4 launch (``k4_call``, against the entry's
    record): one segment as scalar arguments, several through a segment
    table of the call's own in the layout ``csrc/lut_act_multi.cu`` reads,
    each output of its input's shape, the plan of ``k4_plan``, no launch
    for empty inputs; unknown sites, too many segments, a layer outside
    the slab and mixed dtypes are refused."""
    from repro_torch.kernels.lut_act import (
        DTYPE_CODES,
        MAX_SEGMENTS,
        MultiLaunch,
        k4_call,
        k4_plan,
        stacked_record,
    )
    from repro_torch.serve.stacked import multi_site_stacked_entry

    def multi_record(entry):
        sites = entry["meta"]["sites"]
        return MultiLaunch({s: stacked_record(multi_site_stacked_entry(
            entry, s)) for s in sites}, sites)

    ms, stacks_j = superslab
    entry = tables_from_jax(to_np(ms.entry()), device="cpu")
    rec = multi_record(entry)
    sites = entry["meta"]["sites"]
    f32 = DTYPE_CODES[torch.float32]
    x, x2 = torch.zeros(5), torch.zeros(3, 7)
    out, (name, args, held) = k4_call({sites[1]: x}, rec, 1)
    threads, vec, blocks = k4_plan((5,), torch.float32, sm_count=0)
    assert name == "rlut_lut_act_multi" and held == (x,)
    n_recs = len(sites)
    assert args == (rec.addr, n_recs, 1, x.data_ptr(),
                    out[sites[1]].data_ptr(), 5, 1, f32, threads, blocks[0],
                    vec)
    out, (name, args, held) = k4_call({sites[1]: x, sites[3]: x2}, rec, 1)
    threads, vec, blocks = k4_plan((5, 21), torch.float32, sm_count=0)
    table = held[-1]
    assert name == "rlut_lut_act_multi_segs" and held[:2] == (x, x2)
    assert args == (rec.addr, n_recs, 1, ctypes.addressof(table), 2, f32,
                    threads, vec)
    assert [(s.x, s.y, s.n, s.site, s.blocks) for s in table] == [
        (x.data_ptr(), out[sites[1]].data_ptr(), 5, 1, blocks[0]),
        (x2.data_ptr(), out[sites[3]].data_ptr(), 21, 3, blocks[1])]
    assert out[sites[3]].shape == x2.shape and out[sites[3]].is_contiguous()
    out, call = k4_call({sites[0]: torch.zeros(0, 4)}, rec, 0)
    assert call is None and out[sites[0]].shape == (0, 4)
    # nine sites of one stack: more segments than a launch takes
    one = _port_stacks(stacks_j)[sites[0]]
    nine = TMultiSiteSlabs.from_stacks(
        {f"s{i}": one for i in range(MAX_SEGMENTS + 1)}).entry(device="cpu")
    with pytest.raises(ValueError, match="segments"):
        k4_call({s: x for s in nine["meta"]["sites"]}, multi_record(nine),
                0)
    with pytest.raises(ValueError, match="layer"):
        k4_call({sites[1]: x}, rec, ms.n_layers)
    with pytest.raises(ValueError, match="one dtype"):
        k4_call({sites[1]: x, sites[3]: x2.bfloat16()}, rec, 0)
    with pytest.raises(KeyError, match="not in the super-slab"):
        tops.lut_act_multi({"no_such_site": x}, entry, 0)


def _port_greedy(cfg, params, tokens, tables):
    toks = torch.as_tensor(tokens).long()
    logits, cache = prefill(params, cfg, {"tokens": toks}, T + NEW, tables)
    out, lgs = [], [logits[:, -1].numpy()]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(NEW):
        out.append(tok[:, 0].tolist())
        logits, cache = decode_step(params, cfg, cache, tok, T + i, tables)
        lgs.append(logits[:, -1].numpy())
        tok = logits[:, -1].argmax(-1)[:, None]
    return out, lgs


def _compare(ref, got, atol=LUT_ATOL):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def _ref_greedy(cfg, params, tokens, tables):
    return j_greedy(cfg, params, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW, tables)


@pytest.mark.parametrize("form", ["stacked", "fused"])
def test_all_sites_decode_matches_reference(setup, form):
    """``lut_sites="all"``: the unfused stacked gather tables, and the
    fused super-slab on the gather backend (plain K3 for the MLP, plain K4
    for attn_exp / norm_rsqrt / rope_table), against the reference's
    gather decode on the same plans."""
    cj, ct, pj, pt, tokens, plans = setup
    assert sorted(plans.sites) == ALL_SITES
    tj = plans.tables_for_model(backend="gather", mesh=False)
    ref = _ref_greedy(plans.patched_config(cj), pj, tokens, tj)
    if form == "stacked":
        tt = tables_from_jax(to_np(tj), device="cpu")
        ct_l = dataclasses.replace(ct, lut_activation=True)
    else:
        tp = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tp), device="cpu"),
                  backend="gather")
        assert all(tt["sites"][s] == {"multi": s} for s in ALL_SITES)
        ct_l = dataclasses.replace(ct, lut_activation=True, lut_fuse=True)
    _compare(ref, _port_greedy(ct_l, pt, tokens, tt))


def test_logit_softcap_decode_matches_reference():
    """``logit_softcap=30``: the network-global tanh table next to the
    per-layer tables of every other site."""
    cj, ct = _cfgs(logit_softcap=30.0)
    pj = j_init(cj, jax.random.PRNGKey(2))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(2).integers(1, cj.vocab_size, (B, T),
                                               dtype=np.int32)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    plans = j_build(cj, calib)
    assert not plans.sites["logit_softcap"].per_layer
    tj = plans.tables_for_model(backend="gather", mesh=False)
    tt = tables_from_jax(to_np(tj), device="cpu")
    _compare(_ref_greedy(plans.patched_config(cj), pj, tokens, tj),
             _port_greedy(dataclasses.replace(ct, lut_activation=True), pt,
                          tokens, tt))
    # and the exact softcap (no tables) matches too
    _compare(_ref_greedy(cj, pj, tokens, None),
             _port_greedy(ct, pt, tokens, None), atol=2e-5)


def test_all_sites_calibration_matches_reference(setup):
    """Capture keys and bins every site (each over its own domain) as the
    reference does; the masks agree."""
    cj, ct, pj, pt, *_ = setup
    cj2, ct2 = _cfgs(logit_softcap=30.0)
    cap_j = j_capture_model(pj, cj2, j_batches(cj2, 2, batch_size=2,
                                               seq_len=16, seed=1))
    cap_t = t_capture_model(pt, ct2, t_batches(ct2, 2, batch_size=2,
                                               seq_len=16, seed=1))
    want = sorted([f"L{l}/{s}" for l in range(2) for s in ALL_SITES]
                  + ["logit_softcap"])
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == want
    assert cap_t.domains == cap_j.domains
    assert cap_t.domains["L0/attn_exp"] == (-16.0, 0.0)
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        assert ht.sum() == hj.sum(), key
        moved = np.abs(ht - hj).sum() / 2
        assert moved <= HIST_MOVE_FRAC * hj.sum(), (key, moved)
    mj = j_from_capture(cap_j, min_count=1)
    mt = t_from_capture(cap_t, min_count=1)
    assert mt.sites() == mj.sites()
    for key in mj.masks:
        diff = int((mt.masks[key] != mj.masks[key]).sum())
        assert diff <= max(2, HIST_MOVE_FRAC * mj.masks[key].size), key


@pytest.mark.parametrize("argv, sites, softcap, fuse, kernel", [
    ([], "act", None, False, "isolated"),
    (["--lut-sites", "all"], "all", None, False, "isolated"),
    (["--logit-softcap", "30"], "act", 30.0, False, "isolated"),
    (["--lut-sites", "all", "--logit-softcap", "30"], "all", 30.0, False,
     "isolated"),
    (["--lut-sites", "all", "--lut-fuse"], "all", None, True, "fused"),
    (["--lut-sites", "all", "--lut-fuse", "--plan-exec", "unrolled"], "all",
     None, True, "isolated"),
])
def test_launcher_site_flags(argv, sites, softcap, fuse, kernel):
    """``--lut-sites`` / ``--logit-softcap`` reach the config as in the
    reference's launcher (the softcap table is served only with every
    site in scope), and ``--lut-fuse`` picks the fused super-slab exactly
    under stacked execution."""
    args = launcher.parse_args(["--device", "cpu", "--arch", "qwen3-0.6b",
                                "--lut-act", "--calib-steps", "1",
                                "--batch", "2", "--prompt-len", "8"] + argv)
    cfg, params, batch, rng = launcher.setup(args)
    assert (cfg.lut_sites, cfg.logit_softcap, cfg.lut_fuse) == (
        sites, softcap, fuse)
    plans = launcher.build_plans(args, cfg, params, rng, log=lambda m: None)
    tables = launcher.serving_tables(args, plans, "cpu", log=lambda m: None)
    assert tables["kernel"] == kernel
    assert ("logit_softcap" in tables["sites"]) == (
        softcap is not None and sites == "all")
