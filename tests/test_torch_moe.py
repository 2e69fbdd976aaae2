"""The port's moe family against the JAX reference (CPU): the routed
feed-forward (``nn/moe.py``), prefill and greedy decode of the float32
smoke configs of ``deepseek-moe-16b`` (2 shared experts cut to 1) and
``qwen3-moe-30b-a3b`` (no shared expert), exact and with the reference's
own serving tables carried across by ``bridge.tables_from_jax``, the int8
KV cache, calibration capture of the ``expert`` and shared ``mlp`` sites,
the ``expert`` site's slabs, the batchers, and a decode step that reads
nothing back to the host.

The routing is compared assignment by assignment with the reference's
routing lines (``repro/nn/moe.py``: ``jax.lax.top_k``, the stable
``jnp.argsort``, ``jnp.bincount`` and the capacity ranks) run in jax as
written there: the same picks, the same order, the same buffer slots and
the same dropped assignments.

Tolerances, as ``tests/test_torch_decode.py``: float32 outputs of the two
frameworks agree to about 1e-6 relative (matmuls, softmax and norms sum in
other orders), held within ``ATOL`` = 2e-5; with LUT tables an input that
close to a quantizer bin edge can land one output level away, so logits
are held within ``LUT_ATOL`` = 5e-4; greedy tokens must be identical.
Histograms may move a sample across a bin edge for the same reason (at
most ``HIST_MOVE_FRAC`` of a key's samples).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import capture_calibration as j_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.nn.moe import moe_ffn_local as j_moe_ffn_local
from repro.serve import build_serving_plans as j_build
from repro.serve import decode_step as j_decode_step
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro.serve.kvcache import cache_specs as j_cache_specs
from repro.serve.kvcache import init_cache as j_init_cache
from repro.serve.plans import _greedy_decode as j_greedy
from repro_torch import configs as tconfigs
from repro_torch import ioutil
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.launch import serve as launcher
from repro_torch.nn import init_params
from repro_torch.nn.moe import moe_capacity, moe_ffn_local, route
from repro_torch.nn.transformer import param_defs
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    build_serving_plans,
    decode_step,
    init_cache,
    prefill,
    prefill_replay,
)

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
B, T, NEW = 2, 16, 4
ATOL = 2e-5
LUT_ATOL = 5e-4
HIST_MOVE_FRAC = 0.01


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(arch, **kw):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype="float32",
        **kw)
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype="float32",
        **kw)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Both packages' float32 smoke model on the reference's parameters,
    a prompt, and the reference's per-site plans from its own capture."""
    cj, ct = _cfgs(arch)
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(0).integers(1, cj.vocab_size, (B, T),
                                               dtype=np.int32)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    return cj, ct, pj, pt, tokens, j_build(cj, calib)


@functools.lru_cache(maxsize=None)
def _ref_greedy_cached(arch, form):
    cj, _, pj, _, tokens, plans = _model(arch)
    if form == "exact":
        cfg, tables = cj, None
    else:
        cfg = plans.patched_config(cj)
        tables = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
    return j_greedy(cfg, pj, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW, tables)


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


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


# =========================================================================
# configs, parameters and cache shapes
# =========================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    full = tconfigs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(arch))
    assert full.family == "moe" and full.moe is not None
    assert dataclasses.asdict(tconfigs.smoke_config(full)) == \
        dataclasses.asdict(jconfigs.smoke_config(jconfigs.get_config(arch)))


def test_not_ported_lists_the_six_others():
    """The port's ``ARCH_NAMES`` are the reference's ten, in its order:
    none is left unported."""
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert len(tconfigs.ARCH_NAMES) == 10
    assert {tconfigs.get_config(a).family for a in tconfigs.ARCH_NAMES} == {
        "dense", "moe", "vlm", "ssm", "hybrid", "encdec"}


@pytest.mark.parametrize("arch, n_tokens, want", [
    ("deepseek-moe-16b", 4, 8), ("qwen3-moe-30b-a3b", 4, 8),
    ("deepseek-moe-16b", 256, 32), ("qwen3-moe-30b-a3b", 256, 24),
    ("deepseek-moe-16b", 1, 8), ("qwen3-moe-30b-a3b", 1000, 80)])
def test_capacity_is_the_references_formula(arch, n_tokens, want):
    """Decode at 4 slots gives every expert 8 slots on both
    configurations: no assignment is dropped at decode."""
    m = tconfigs.get_config(arch).moe
    assert moe_capacity(n_tokens, m) == want
    ref = -(-max(int(n_tokens * m.top_k / m.n_experts * m.capacity_factor),
                 m.top_k) // 8) * 8
    assert moe_capacity(n_tokens, m) == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_is_bit_exact(arch):
    """Every moe name (router, moe_w_in / moe_w_out, sh_w_in / sh_w_out)
    comes across by name, bf16 bits included."""
    cj = jconfigs.smoke_config(jconfigs.get_config(arch))
    ct = tconfigs.smoke_config(tconfigs.get_config(arch))
    pj = to_np(j_init(cj, jax.random.PRNGKey(1)))
    pt = params_from_jax(pj, ct, device="cpu")
    want = {"router", "moe_w_in", "moe_w_out"}
    if ct.moe.n_shared:
        want |= {"sh_w_in", "sh_w_out"}
    assert want <= set(pt.blocks) and "w_in" not in pt.blocks
    assert set(pt.blocks) == set(pj["blocks"])
    for name, t in pt.blocks.items():
        leaf = pj["blocks"][name]
        assert tuple(t.shape) == leaf.shape, name
        assert t.dtype == torch.bfloat16
        assert leaf.view(np.int16).tobytes() == \
            t.view(torch.int16).numpy().tobytes(), name


def test_init_params_draws_a_layer_at_a_time():
    """Each layer of a stack is its own draw with the reference's
    distribution: zeros, or a normal truncated at +-2 scaled by
    ``scale / sqrt(fan_in)``; no layer repeats another."""
    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("deepseek-moe-16b")),
        dtype="float32", n_layers=3)
    params = init_params(cfg, seed=5, device="cpu")
    defs = param_defs(cfg)["blocks"]
    for name, d in defs.items():
        t = params.blocks[name]
        if d.scale == 0.0:
            assert not t.any(), name
            continue
        bound = 2.0 * d.scale / np.sqrt(d.shape[-2])
        assert float(t.abs().max()) <= bound * (1 + 1e-6), name
        for i in range(1, cfg.n_layers):
            assert not torch.equal(t[0], t[i]), name
    w = params.blocks["moe_w_in"]
    # a normal truncated at +-2 has standard deviation 0.8796
    std = float(w.std()) * np.sqrt(cfg.d_model)
    assert abs(std - 0.8796) < 0.03
    again = init_params(cfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_cache_is_the_references(kv_dtype):
    for arch in ARCHS:
        cfg = tconfigs.get_config(arch)
        cache = init_cache(cfg, 4, 80, device="cpu",
                           kv_dtype="int8" if kv_dtype == "int8" else None)
        spec = j_cache_specs(jconfigs.get_config(arch), 4, 80,
                             kv_dtype=kv_dtype)
        assert sorted(cache) == sorted(spec)
        for name, s in spec.items():
            assert tuple(cache[name].shape) == s.shape, name
            assert str(cache[name].dtype).split(".")[-1] == s.dtype.name


# =========================================================================
# the routed feed-forward
# =========================================================================
def _ref_route(x, router_w, *, n_experts, top_k, capacity):
    """The routing lines of the reference's ``moe_ffn_local`` (one
    device, ``e0 = 0``), as written there."""
    s = x.shape[0]
    logits = jnp.einsum("sd,de->se", x.astype(jnp.float32), router_w)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_ids = jax.lax.top_k(probs, top_k)
    flat_ids = top_ids.reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    counts = jnp.bincount(flat_ids, length=n_experts)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(s * top_k) - starts[sorted_ids]
    keep = rank < capacity
    slot = jnp.where(keep, sorted_ids * capacity + rank,
                     n_experts * capacity)
    return [np.asarray(a) for a in (top_ids, order, slot, keep, counts)]


def _ffn_inputs(seed, s, d, e, f, router_scale):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) * router_scale).astype(np.float32)
    w_in = (rng.normal(size=(e, d, 2 * f)) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, router, w_in, w_out


FFN_CASES = {"top-2 of 8": dict(s=32, e=8, k=2, f=8, cf=1.0),
             "top-6 of 64": dict(s=64, e=64, k=6, f=8, cf=1.0)}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_routing_and_drops_match_reference(case):
    """Top-k picks, expert-sorted order, buffer slots and the dropped
    assignments are the reference's exactly (capacity small enough that
    some are dropped); outputs and aux within ``ATOL``."""
    c = FFN_CASES[case]
    s, e, k = c["s"], c["e"], c["k"]
    from types import SimpleNamespace

    cap = moe_capacity(s, SimpleNamespace(top_k=k, n_experts=e,
                                          capacity_factor=c["cf"]))
    x, router, w_in, w_out = _ffn_inputs(3, s, 16, e, c["f"], 0.6)
    want = _ref_route(jnp.asarray(x), jnp.asarray(router), n_experts=e,
                      top_k=k, capacity=cap)
    r = route(torch.from_numpy(x), torch.from_numpy(router), n_experts=e,
              top_k=k, capacity=cap)
    got = [t.numpy() for t in (r.top_ids, r.order, r.slot, r.keep,
                               r.counts)]
    for name, a, b in zip(("top_ids", "order", "slot", "keep", "counts"),
                          want, got):
        np.testing.assert_array_equal(b, a, err_msg=name)
    n_drop = int((~want[3]).sum())
    assert n_drop > 0 and int(r.dropped()) == n_drop
    yj, auxj = jax.jit(functools.partial(
        j_moe_ffn_local, n_experts=e, top_k=k, capacity=cap, e0=0))(
            *(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    yt, auxt = moe_ffn_local(*(torch.from_numpy(a) for a in (
        x, router, w_in, w_out)), n_experts=e, top_k=k, capacity=cap)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=0, atol=ATOL)
    # a token whose every pick was dropped gets nothing
    tok_drop = np.zeros(s, int)
    np.add.at(tok_drop, want[1][~want[3]] // k, 1)
    for tok in np.nonzero(tok_drop == k)[0]:
        assert not yt[tok].any()


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_tied_router_picks_the_lowest_ids(case):
    """A zero router ties every expert: both packages pick experts
    ``0 .. k-1`` for every token (``torch.topk`` would not)."""
    c = FFN_CASES[case]
    s, e, k = c["s"], c["e"], c["k"]
    x, _, w_in, w_out = _ffn_inputs(4, s, 16, e, c["f"], 0.0)
    router = np.zeros((16, e), np.float32)
    cap = 8
    want = _ref_route(jnp.asarray(x), jnp.asarray(router), n_experts=e,
                      top_k=k, capacity=cap)
    r = route(torch.from_numpy(x), torch.from_numpy(router), n_experts=e,
              top_k=k, capacity=cap)
    lowest = np.broadcast_to(np.arange(k), (s, k))
    np.testing.assert_array_equal(want[0], lowest)
    np.testing.assert_array_equal(r.top_ids.numpy(), lowest)
    np.testing.assert_array_equal(r.slot.numpy(), want[2])
    yj, _ = jax.jit(functools.partial(
        j_moe_ffn_local, n_experts=e, top_k=k, capacity=cap, e0=0))(
            *(jnp.asarray(a) for a in (x, router, w_in, w_out)))
    yt, _ = moe_ffn_local(*(torch.from_numpy(a) for a in (
        x, router, w_in, w_out)), n_experts=e, top_k=k, capacity=cap)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=ATOL)


# =========================================================================
# prefill and greedy decode against the reference
# =========================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_decode_matches_reference(arch):
    _, ct, _, pt, tokens, _ = _model(arch)
    _compare(_ref_greedy_cached(arch, "exact"),
             _port_greedy(ct, pt, tokens, None), ATOL)


@pytest.mark.parametrize("form", ["stacked", "unrolled", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lut_decode_matches_reference(arch, form):
    """The reference's per-site plans (``expert``, and deepseek's shared
    ``mlp``) in each execution form on the port's gather backend: the
    stacked and unrolled tables, and the fused super-slab (the expert
    site through the plain K4, the shared MLP through the plain K3),
    against the reference's gather decode on the same plans."""
    _, ct, _, pt, tokens, plans = _model(arch)
    want_sites = ["expert", "mlp"] if ct.moe.n_shared else ["expert"]
    assert sorted(plans.sites) == want_sites
    assert all(sp.per_layer for sp in plans.sites.values())
    ct_l = dataclasses.replace(ct, lut_activation=True)
    if form == "fused":
        tj = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tj), device="cpu"),
                  backend="gather")
        assert all(tt["sites"][s] == {"multi": s} for s in want_sites)
        ct_l = dataclasses.replace(ct_l, lut_fuse=True)
        ref = _ref_greedy_cached(arch, "stacked")
    else:
        tj = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
        tt = tables_from_jax(to_np(tj), device="cpu")
        ref = _ref_greedy_cached(arch, form)
    _compare(ref, _port_greedy(ct_l, pt, tokens, tt), LUT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_cache_decode_matches_reference(arch):
    """The prompt and the decoded tokens stepped through both packages'
    decode step on an int8 KV cache: logits within ``ATOL`` every step,
    int8 entries equal."""
    cj, ct, pj, pt, tokens, _ = _model(arch)
    n = T + NEW
    toks = np.concatenate([tokens, np.random.default_rng(1).integers(
        1, ct.vocab_size, (B, NEW), dtype=np.int32)], axis=1)
    cache = init_cache(ct, B, n, device="cpu", kv_dtype="int8")
    jcache = j_init_cache(cj, B, n, kv_dtype="int8")
    jstep = jax.jit(lambda p, c, tk, pos: j_decode_step(p, cj, c, tk, pos))
    for i in range(n):
        lg, cache = decode_step(pt, ct, cache,
                                torch.as_tensor(toks[:, i:i + 1]).long(), i)
        jlg, jcache = jstep(pj, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(i))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))


# =========================================================================
# calibration and the expert site's slabs
# =========================================================================
@pytest.mark.parametrize("arch", ARCHS)
def test_capture_matches_reference(arch):
    """``L{i}/expert`` for every layer (every capacity slot, empty ones
    included) and, on deepseek, ``L{i}/mlp`` for the shared experts: the
    reference's keys, sample counts and histograms."""
    cj, ct, pj, pt, *_ = _model(arch)
    cap_j = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2,
                                              seq_len=16, seed=1))
    cap_t = t_capture_model(pt, ct, t_batches(ct, 2, batch_size=2,
                                              seq_len=16, seed=1))
    sites_ = ["expert", "mlp"] if ct.moe.n_shared else ["expert"]
    want = sorted(f"L{l}/{s}" for l in range(ct.n_layers) for s in sites_)
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == want
    assert (cap_t.n_samples, cap_t.n_batches) == (cap_j.n_samples,
                                                  cap_j.n_batches)
    cap = moe_capacity(2 * 16, ct.moe)
    assert cap_t.hists["L0/expert"].sum() == \
        2 * ct.moe.n_experts * cap * ct.moe.d_expert
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        assert ht.sum() == hj.sum(), key
        moved = np.abs(ht - hj).sum() / 2
        assert moved <= HIST_MOVE_FRAC * hj.sum(), (key, moved)
        np.testing.assert_allclose(cap_t.ranges[key], cap_j.ranges[key],
                                   rtol=1e-5)


def _flat(tree, prefix=""):
    """``{path: numpy array}`` of a tables tree's arrays."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.numpy()
    elif isinstance(tree, np.ndarray):
        out[prefix] = tree
    return out


@pytest.mark.parametrize("form", ["stacked", "unrolled", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_slabs_equal_reference(arch, form):
    """The port's plans from the reference's calibration serve the
    ``expert`` site with the reference's slabs: equal payload checksums
    (and bytes) in the stacked and unrolled forms, raw and bit-packed,
    and in the fused super-slab."""
    from repro.calib import calibration_from_capture as j_from_capture
    from repro_torch.calib import CalibrationSet as TCalib

    cj, ct, pj, *_ = _model(arch)
    cap_j = j_capture_model(pj, cj, j_batches(cj, 1, batch_size=2,
                                              seq_len=8, seed=1))
    calib_j = j_from_capture(cap_j)
    calib_t = TCalib(masks=calib_j.masks, w_in=calib_j.w_in,
                     x_lo=calib_j.x_lo, x_hi=calib_j.x_hi,
                     hists=calib_j.hists, ranges=calib_j.ranges)
    pj_, pt_ = j_build(cj, calib_j), build_serving_plans(ct, calib_t)
    assert pj_.total_cost == pt_.total_cost
    assert pt_.sites["expert"].per_layer
    if form == "fused":
        pairs = [(pj_.tables_for_model(backend="pallas", kernel="fused",
                                       mesh=False)["multi"],
                  pt_.tables_for_model(backend="cuda", kernel="fused",
                                       device="cpu")["multi"])]
        assert "expert" in pairs[0][1]["meta"]["sites"]
    else:
        exec_ = "unrolled" if form == "unrolled" else "stacked"
        pairs = [(pj_.tables_for_model(backend=bj, plan_exec=exec_,
                                       mesh=False)["sites"]["expert"],
                  pt_.tables_for_model(backend=bt, plan_exec=exec_,
                                       device="cpu")["sites"]["expert"])
                 for bj, bt in (("gather", "gather"), ("pallas", "cuda"))]
    for tj, tt in pairs:
        fj, ft = _flat(to_np(tj)), _flat(tt)
        assert sorted(fj) == sorted(ft) and fj
        assert ioutil.payload_checksum(ft) == ioutil.payload_checksum(fj)
        for k in fj:
            assert fj[k].tobytes() == ft[k].tobytes(), k


# =========================================================================
# a step that reads nothing back to the host
# =========================================================================
def _smoke(arch, seed=3):
    cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    return cfg, init_params(cfg, seed=seed, device="cpu")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tensor_pos_gives_int_pos_bits(kv):
    """``pos`` as a 0-d tensor (what a captured step reads) gives the bits
    of ``pos`` as a Python int, logits and cache, on deepseek's smoke
    config (bf16)."""
    cfg, params = _smoke("deepseek-moe-16b")
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 6)))
    if kv == "int8":
        cache = init_cache(cfg, 2, 8, device="cpu", kv_dtype="int8")
        _, cache = prefill_replay(params, cfg, cache, toks[:, :5])
    else:
        _, cache = prefill(params, cfg, {"tokens": toks[:, :5]}, max_seq=8)
    outs = []
    for p in (5, torch.tensor(5)):
        c = {k: v.clone() for k, v in cache.items()}
        lg, c = decode_step(params, cfg, c, toks[:, 5:], p)
        outs.append((lg, c))
    (li, ci), (lt, ct_) = outs
    assert torch.equal(li, lt)
    for name in ci:
        assert torch.equal(ci[name], ct_[name]), name


def _refuse(name):
    def refused(*a, **kw):
        raise AssertionError(f"{name} on the decode step")
    return refused


def test_decode_step_has_no_host_sync_or_atomic_sum(monkeypatch):
    """A moe decode step with LUT tables, every site in scope and an int8
    cache calls nothing that reads a tensor back to the host (``item``,
    ``tolist``, truth values, ``nonzero``, ``bincount``), no ``topk``
    (ties), and no accumulating index update (atomics on the card)."""
    arch = "deepseek-moe-16b"
    cfg, params = _smoke(arch)
    cfg = dataclasses.replace(cfg, lut_sites="all")
    calib = np.random.default_rng(0).normal(size=20000) * 3
    tables = build_serving_plans(cfg, calib).tables_for_model(device="cpu")
    cfg = dataclasses.replace(cfg, lut_activation=True)
    cache = init_cache(cfg, 2, 4, device="cpu", kv_dtype="int8")
    tok = torch.tensor([[5], [7]])
    orig_put = torch.Tensor.index_put_

    def index_put_(self, indices, values, accumulate=False):
        if accumulate:
            raise AssertionError("index_put_(accumulate=True) on the step")
        return orig_put(self, indices, values)

    for owner, names in ((torch.Tensor, ("item", "tolist", "__bool__",
                                         "nonzero", "bincount", "topk",
                                         "index_add_", "index_add")),
                         (torch, ("nonzero", "bincount", "topk",
                                  "index_add"))):
        for name in names:
            monkeypatch.setattr(owner, name, _refuse(name))
    monkeypatch.setattr(torch.Tensor, "index_put_", index_put_)
    lg, _ = decode_step(params, cfg, cache, tok, 1, tables)
    assert lg.shape == (2, 1, cfg.vocab_size)


# =========================================================================
# the batchers and the launcher
# =========================================================================
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_staggered_requests_match_reference_batcher(kv_dtype):
    """Requests of several lengths, more than the slots, through both
    batchers on deepseek's float32 smoke config (``prefill="step"``):
    identical tokens request by request, nothing dropped."""
    cj, ct, pj, pt, *_ = _model("deepseek-moe-16b")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, ct.vocab_size, n) for n in (5, 2, 9, 4, 7)]
    outs = []
    for cls, req, cfg, params in ((JBatcher, JRequest, cj, pj),
                                  (ContinuousBatcher, Request, ct, pt)):
        b = cls(cfg, params, batch_size=3, max_seq=24, eos_token=-1,
                kv_dtype=kv_dtype, prefill="step")
        for i, p in enumerate(prompts):
            b.submit(req(rid=i, prompt=list(p), max_new=5))
        outs.append([r.out for r in sorted(b.run(), key=lambda r: r.rid)])
    assert outs[1] == outs[0]
    assert all(len(o) == 5 for o in outs[1])
    assert b.metrics()["dropped"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_cpu(arch, capsys):
    """``--arch`` takes both moe configurations; ``--kv-int8`` replays the
    prompt into an int8 cache for the moe family; the parameter line is
    printed."""
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3", "--lut-act",
            "--calib-steps", "1", "--lut-backend", "gather"]
    out = launcher.main(argv + ["--kv-int8"])
    printed = capsys.readouterr().out
    assert "int8 KV cache enabled" in printed
    assert f"{arch}-smoke: parameters: " in printed
    assert out["replay_s"] is not None
    assert len(out["tokens"]) == 2 and len(out["tokens"][0]) == 3
