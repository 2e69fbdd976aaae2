"""The port's encdec family (``whisper-small``: a bidirectional encoder over
``n_frames`` stubbed audio frames with a sinusoidal position table, and a
decoder with rope self-attention, cross-attention over the encoder output
and an MLP) against the JAX reference on the CPU: configs, the bridge,
``_sinusoid``, the encoder and decoder forwards, the cache (self K/V and
read-only cross K/V), prefill, greedy decode exact and with the
reference's tables, calibration capture with the encoder's layer-agnostic
keys, the batch draws, ``pos`` as a tensor, a step with no host read,
calibration and tuned-plan files across the packages, and the launcher.

The reference's ``encdec_prefill`` drops ``max_seq``: its self-attention
cache holds exactly the prompt's ``T`` positions, so its decode writes
every token at slot ``T - 1`` (ROADMAP queue C).  The port pads the cache
to ``max_seq`` as the decoder families do; to hold the two decodes
against each other, the tests pad the reference's prefill cache before
stepping it.

Tolerances: float32 forwards of the two frameworks agree to about 1e-6
relative; the encoder and decoder forwards are held within ``ATOL`` =
1e-5, logits and caches within ``ATOL`` too.  With LUT tables an input
that close to a quantizer bin edge can land one output level away, so
logits are held within ``LUT_ATOL`` = 5e-4; greedy tokens must be
identical.  ``_sinusoid``: ``torch.pow`` and XLA's ``pow`` differ in the
last ulp for 4 of whisper's 384 frequencies, and ``sin`` / ``cos`` in the
last ulp for about a third of the entries; an angle ``pos / f`` one ulp
off moves ``sin`` by up to ``pos * 2**-23``, so an ``n``-position table
is held within ``n * 2**-23 + 2**-23``: 1.8e-4 for whisper's 1500 (3.1e-5
is seen), 2.0e-6 for the smoke config's 16.
Histograms may move a sample across a bin edge for the same reason (at
most ``HIST_MOVE_FRAC`` of a key's samples).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import capture_calibration as j_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import calibration_from_capture as j_from_capture
from repro.calib import load_calibration as j_load_calib
from repro.calib import model_batch as j_model_batch
from repro.calib import save_calibration as j_save_calib
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.nn.transformer import _sinusoid as j_sinusoid
from repro.nn.transformer import encdec_forward as j_encdec_forward
from repro.nn.transformer import encoder_forward as j_encoder_forward
from repro.nn.transformer import param_defs as j_param_defs
from repro.serve import build_serving_plans as j_build
from repro.serve import decode_step as j_decode_step
from repro.serve import prefill as j_prefill
from repro.serve.kvcache import cache_specs as j_cache_specs
from repro.tune.artifact import load_tuned_plan as j_load_plan
from repro.tune.artifact import save_tuned_plan as j_save_plan
from repro.tune.artifact import tuned_plan_from_serving as j_freeze
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import CalibrationSet as TCalib
from repro_torch.calib import calibration_from_capture as t_from_capture
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import load_calibration as t_load_calib
from repro_torch.calib import model_batch as t_model_batch
from repro_torch.calib import save_calibration as t_save_calib
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.launch import serve as launcher
from repro_torch.nn import EncDecParams, init_params
from repro_torch.nn.transformer import (
    _sinusoid,
    encdec_forward,
    encoder_forward,
)
from repro_torch.serve import (
    build_serving_plans,
    clone_state,
    decode_start,
    decode_step,
    greedy_decode,
    init_cache,
    prefill,
    state_leaves,
)
from repro_torch.tune import load_tuned_plan, save_tuned_plan
from repro_torch.tune import tuned_plan_from_serving

ARCH = "whisper-small"
B, T, NEW = 2, 8, 4
F = 16                   # the smoke config's frames
PAD = 3                  # max_seq past the prompt and the new tokens
ATOL = 1e-5
LUT_ATOL = 5e-4
HIST_MOVE_FRAC = 0.01
ULP = 2.0 ** -23


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(**kw):
    cj = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(ARCH)),
                             dtype="float32", **kw)
    ct = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                             dtype="float32", **kw)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


@functools.lru_cache(maxsize=None)
def _model(sites="act"):
    """Both packages' float32 smoke model on the reference's parameters, a
    batch of ``T`` tokens and ``F`` frames (the reference's
    ``model_batch``), and the reference's per-site plans."""
    cj, ct = _cfgs(lut_sites=sites)
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    batch = j_model_batch(cj, np.random.default_rng(0), B, T)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    return cj, ct, pj, pt, batch, j_build(cj, calib)


def _tbatch(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pad_self_kv(cache, max_seq):
    """The reference's prefill cache with its self K/V padded with zeros to
    ``max_seq`` positions, as the port's prefill pads its own."""
    pad = max_seq - cache["k"].shape[2]
    return {n: (jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                if n in ("k", "v") else c) for n, c in cache.items()}


def _port_greedy(cfg, params, batch, tables):
    tb = _tbatch(batch)
    logits, cache = prefill(params, cfg, tb, T + NEW + PAD, tables)
    out, lgs = [], [logits[:, -1].numpy()]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(NEW):
        out.append(tok[:, 0].tolist())
        logits, cache = decode_step(params, cfg, cache, tok, T + i, tables)
        lgs.append(logits[:, -1].numpy())
        tok = logits[:, -1].argmax(-1)[:, None]
    return out, lgs


@functools.lru_cache(maxsize=None)
def _ref_greedy(sites, form):
    """The reference's greedy decode (jitted prefill and step) from its
    prefill cache padded to ``T + NEW + PAD``."""
    cj, _, pj, _, batch, plans = _model(sites)
    if form == "exact":
        cfg, tables = cj, None
    else:
        cfg = plans.patched_config(cj)
        tables = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
    lg, cache = jax.jit(lambda p, b: j_prefill(p, cfg, b, lut_tables=tables))(
        pj, _jbatch(batch))
    cache = _pad_self_kv(cache, T + NEW + PAD)
    step = jax.jit(lambda p, c, tk, pos: j_decode_step(
        p, cfg, c, tk, pos, lut_tables=tables))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    toks, logits = [], [np.asarray(lg[:, -1])]
    for i in range(NEW):
        toks.append(np.asarray(tok)[:, 0].tolist())
        lg, cache = step(pj, cache, tok, jnp.asarray(T + i))
        logits.append(np.asarray(lg[:, -1]))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    return toks, logits


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


# =========================================================================
# configs, parameters, the position table and the cache
# =========================================================================
def test_config_and_smoke_config_equal_reference():
    full = tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert (full.family, full.n_layers, full.n_encoder_layers, full.n_frames,
            full.d_model, full.activation) == ("encdec", 12, 12, 1500, 768,
                                               "gelu")
    assert full.n_params() == jconfigs.get_config(ARCH).n_params()
    smoke = tconfigs.smoke_config(full)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        jconfigs.smoke_config(jconfigs.get_config(ARCH)))
    assert (smoke.n_frames, smoke.n_encoder_layers) == (F, 2)


def test_params_bridge_is_bit_exact():
    cj = jconfigs.smoke_config(jconfigs.get_config(ARCH))
    ct = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    pj = to_np(j_init(cj, jax.random.PRNGKey(1)))
    pt = params_from_jax(pj, ct, device="cpu")
    assert isinstance(pt, EncDecParams)
    assert sorted(pt.dec_blocks.keys()) == sorted(pj["dec_blocks"])
    assert {"xwq", "xwk", "xwv", "xwo", "lnx"} <= set(pt.dec_blocks.keys())
    assert sorted(pt.enc_blocks.keys()) == sorted(pj["enc_blocks"])
    assert pt.enc_norm.shape == (64,) and pt.enc_norm.dtype == torch.bfloat16
    for tree in ("enc_blocks", "dec_blocks"):
        for name, t in getattr(pt, tree).items():
            assert pj[tree][name].view(np.int16).tobytes() == \
                t.view(torch.int16).numpy().tobytes(), (tree, name)
    assert pt.enc_layer(1)["w_in"].shape == (64, 128)
    assert pt.layer(1)["xwk"].shape == (64, 32)


def test_full_width_parameters():
    """Counted on the meta device: the reference's parameter definitions,
    leaf for leaf (0.28 G at full width)."""
    cfg = tconfigs.get_config(ARCH)
    meta = EncDecParams(cfg, device="meta")
    want = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[prefix + k] = tuple(v.shape)
    walk(j_param_defs(jconfigs.get_config(ARCH)))
    got = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    assert got == want
    assert meta.dec_blocks["xwk"].shape == (12, 768, 768)
    assert sum(p.numel() for p in meta.parameters()) == sum(
        math.prod(s) for s in want.values()) == 277_893_120


@pytest.mark.parametrize("n, d", [(F, 64), (1500, 768)])
def test_sinusoid_matches_reference(n, d):
    want = np.asarray(j_sinusoid(n, d))
    got = _sinusoid(n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=n * ULP + ULP)


def test_init_cache_matches_reference_specs():
    cfg = tconfigs.get_config(ARCH)
    cache = init_cache(cfg, 4, 80, device="meta")
    spec = j_cache_specs(jconfigs.get_config(ARCH), 4, 80)
    assert sorted(cache) == sorted(spec) == ["k", "v", "xk", "xv"]
    for name, s in spec.items():
        assert tuple(cache[name].shape) == s.shape, name
        assert str(cache[name].dtype).split(".")[-1] == s.dtype.name
    assert cache["xk"].shape == (12, 4, 1500, 12, 64)


def test_model_batch_draws_the_references_numbers():
    """Tokens, then ``rng.normal`` frames cast to float32, bit for bit,
    batch after batch: both packages calibrate on the same numbers."""
    cfg = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    jcfg = jconfigs.smoke_config(jconfigs.get_config(ARCH))
    for a, b in zip(t_batches(cfg, 3, batch_size=2, seq_len=7, seed=4),
                    j_batches(jcfg, 3, batch_size=2, seq_len=7, seed=4)):
        assert sorted(a) == sorted(b) == ["frames", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    one = t_model_batch(cfg, np.random.default_rng(0), 2, 7)
    assert one["frames"].shape == (2, F, 64)


# =========================================================================
# the forwards, prefill and greedy decode against the reference
# =========================================================================
def test_encoder_and_decoder_forward_match_reference():
    cj, ct, pj, pt, batch, _ = _model()
    enc_j = jax.jit(lambda p, f: j_encoder_forward(p, cj, f))(
        pj, jnp.asarray(batch["frames"]))
    enc_t = encoder_forward(pt, ct, torch.as_tensor(batch["frames"]))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), rtol=0,
                               atol=ATOL)
    x_j, _ = jax.jit(lambda p, tk, e: j_encdec_forward(p, cj, tk, e))(
        pj, jnp.asarray(batch["tokens"]), enc_j)
    x_t = encdec_forward(pt, ct, torch.as_tensor(batch["tokens"]).long(),
                         enc_t)
    assert x_t.shape == (B, T, 64)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=ATOL)


def test_prefill_logits_and_caches_match_reference():
    """Logits, the self K/V (the reference's padded to ``max_seq`` here)
    and the cross K/V of every decoder layer."""
    cj, ct, pj, pt, batch, _ = _model()
    max_seq = T + NEW + PAD
    lj, cache_j = jax.jit(lambda p, b: j_prefill(p, cj, b))(pj,
                                                             _jbatch(batch))
    cache_j = _pad_self_kv(cache_j, max_seq)
    lt, cache_t = prefill(pt, ct, _tbatch(batch), max_seq)
    assert sorted(cache_t) == ["k", "v", "xk", "xv"]
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    for name in cache_t:
        assert cache_t[name].shape == cache_j[name].shape, name
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=0,
                                   atol=ATOL, err_msg=name)
    assert cache_t["xk"].shape == (ct.n_layers, B, F, ct.n_kv_heads,
                                   ct.d_head)
    assert not cache_t["k"][:, :, T:].any()


def test_reference_drops_max_seq_and_the_port_pads():
    """The reference's cache keeps ``T`` positions whatever ``max_seq``,
    and each of its decode steps overwrites slot ``T - 1``; the port's
    holds ``max_seq`` and writes step ``i`` at slot ``T + i``, leaving the
    prompt's entries as they were."""
    cj, ct, pj, pt, batch, _ = _model()
    max_seq = T + 3
    lj, cj_ = jax.jit(lambda p, b: j_prefill(p, cj, b, max_seq=max_seq))(
        pj, _jbatch(batch))
    lt, ct_ = prefill(pt, ct, _tbatch(batch), max_seq)
    assert cj_["k"].shape[2] == T and ct_["k"].shape[2] == max_seq
    step = jax.jit(lambda p, c, tk, pos: j_decode_step(p, cj, c, tk, pos))
    ref0, port0 = np.asarray(cj_["k"]), ct_["k"].clone()
    tok = torch.full((B, 1), 3)
    for i in range(3):
        _, cj_ = step(pj, cj_, jnp.asarray(tok.numpy()), jnp.asarray(T + i))
        _, ct_ = decode_step(pt, ct, ct_, tok, T + i)
    ref1 = np.asarray(cj_["k"])
    assert ref1.shape[2] == T
    assert (ref1[:, :, :T - 1] == ref0[:, :, :T - 1]).all()
    assert (ref1[:, :, T - 1] != ref0[:, :, T - 1]).any()
    assert torch.equal(ct_["k"][:, :, :T], port0[:, :, :T])
    assert all(ct_["k"][:, :, T + i].abs().sum() > 0 for i in range(3))


def test_exact_decode_matches_reference():
    _, ct, _, pt, batch, _ = _model()
    _compare(_ref_greedy("act", "exact"), _port_greedy(ct, pt, batch, None),
             ATOL)


@pytest.mark.parametrize("sites, form", [
    ("act", "stacked"), ("act", "unrolled"), ("act", "fused"),
    ("all", "stacked"), ("all", "fused")])
def test_lut_decode_matches_reference(sites, form):
    """The reference's per-site plans on the port's gather backend: the
    stacked and unrolled tables, and the fused super-slab (``mlp`` through
    the plain K3 without a gate, the other sites, cross-attention's
    ``attn_exp`` over the frames included, through the plain K4), against
    the reference's gather decode on the same plans."""
    cj, ct, pj, pt, batch, plans = _model(sites)
    ct_l = dataclasses.replace(ct, lut_activation=True)
    if form == "fused":
        tj = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tj), device="cpu"),
                  backend="gather")
        assert all(tt["sites"][s] == {"multi": s} for s in plans.sites)
        ct_l = dataclasses.replace(ct_l, lut_fuse=True)
        ref = _ref_greedy(sites, "stacked")
    else:
        tj = plans.tables_for_model(backend="gather", mesh=False,
                                    plan_exec=form)
        tt = tables_from_jax(to_np(tj), device="cpu")
        ref = _ref_greedy(sites, form)
    _compare(ref, _port_greedy(ct_l, pt, batch, tt), LUT_ATOL)


def test_greedy_decode_takes_the_batch():
    """``serve.greedy_decode`` on a batch dict with frames decodes from
    ``T`` through the padded cache: the reference's tokens."""
    _, ct, _, pt, batch, plans = _model()
    tt = tables_from_jax(to_np(plans.tables_for_model(backend="gather",
                                                      mesh=False)),
                         device="cpu")
    ct_l = dataclasses.replace(ct, lut_activation=True)
    assert decode_start(ct_l, _tbatch(batch)) == T
    toks = greedy_decode(ct_l, pt, _tbatch(batch), NEW, T + NEW + PAD, tt)
    want = _ref_greedy("act", "stacked")[0]
    assert toks == [list(r) for r in zip(*want)]


# =========================================================================
# calibration: the layer-agnostic encoder keys
# =========================================================================
@pytest.mark.parametrize("sites, agnostic", [
    ("act", ["mlp"]), ("all", ["attn_exp", "mlp"])])
def test_capture_matches_reference(sites, agnostic):
    """The decoder's ``L{i}/{site}`` keys and the encoder's keys with no
    layer (its ``mlp``, and under every site its ``attn_exp`` over the
    frame-by-frame scores): the reference's keys, sample counts, bins and
    output ranges."""
    cj, ct, pj, pt, *_ = _model(sites)
    cap_j = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2,
                                              seq_len=9, seed=1))
    cap_t = t_capture_model(pt, ct, t_batches(ct, 2, batch_size=2,
                                              seq_len=9, seed=1))
    assert sorted(cap_t.hists) == sorted(cap_j.hists)
    assert sorted(k for k in cap_t.hists if "/" not in k) == agnostic
    assert cap_t.hists["mlp"].sum() == 2 * 2 * F * ct.d_ff * \
        ct.n_encoder_layers
    if sites == "all":
        assert cap_t.hists["attn_exp"].sum() == 2 * 2 * ct.n_heads * F * F \
            * ct.n_encoder_layers
    assert (cap_t.n_samples, cap_t.n_batches) == (cap_j.n_samples,
                                                  cap_j.n_batches)
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        moved = np.abs(ht - hj).sum() / 2
        assert ht.sum() == hj.sum() and moved <= HIST_MOVE_FRAC * hj.sum(), \
            key
        np.testing.assert_allclose(cap_t.ranges[key], cap_j.ranges[key],
                                   rtol=1e-5, err_msg=key)
    masks_t = t_from_capture(cap_t).masks
    masks_j = j_from_capture(cap_j).masks
    assert sorted(masks_t) == sorted(masks_j)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_calibration_loads_in_the_other_package(tmp_path, saver):
    """An encdec calibration, the layer-agnostic keys included, saved by
    either package loads in the other bit for bit, and builds the same
    plans there."""
    cj, ct, pj, *_ = _model("all")
    calib_j = j_capture(pj, cj, j_batches(cj, 1, batch_size=2, seq_len=8,
                                          seed=1))
    assert {"mlp", "attn_exp"} <= set(calib_j.masks)
    calib_t = TCalib(masks=calib_j.masks, w_in=calib_j.w_in,
                     x_lo=calib_j.x_lo, x_hi=calib_j.x_hi,
                     hists=calib_j.hists, ranges=calib_j.ranges,
                     meta=calib_j.meta)
    if saver == "reference":
        loaded = t_load_calib(j_save_calib(str(tmp_path / "c"), calib_j))
    else:
        loaded = j_load_calib(t_save_calib(str(tmp_path / "c"), calib_t))
    for f in ("masks", "hists", "ranges"):
        got, want = getattr(loaded, f), getattr(calib_j, f)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), (f, k)
    assert build_serving_plans(ct, calib_t).total_cost == \
        j_build(cj, calib_j).total_cost


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_tuned_plan_loads_in_the_other_package(tmp_path, saver):
    """Per-layer encdec plans frozen by either package load in the other,
    and their tables serve the reference's tokens in the port."""
    cj, ct, pj, pt, batch, plans_j = _model()
    if saver == "reference":
        tp = load_tuned_plan(j_save_plan(str(tmp_path / "p"),
                                         j_freeze(cj, plans_j)))
        assert (tp.family, tp.per_layer) == ("encdec", {"mlp": True})
        cfg = tp.patched_config(ct)
        tables = tp.tables_for_model(backend="gather", device="cpu")
    else:
        calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                            seed=1))
        plans_t = build_serving_plans(ct, TCalib(
            masks=calib.masks, w_in=calib.w_in, x_lo=calib.x_lo,
            x_hi=calib.x_hi, hists=calib.hists, ranges=calib.ranges))
        assert plans_t.sites["mlp"].per_layer
        jp = j_load_plan(save_tuned_plan(str(tmp_path / "p"),
                                         tuned_plan_from_serving(ct,
                                                                 plans_t)))
        assert (jp.arch, jp.family, jp.n_layers, jp.per_layer) == (
            ct.name, "encdec", 2, {"mlp": True})
        cfg = plans_t.patched_config(ct)
        tables = tables_from_jax(to_np(jp.tables_for_model(backend="gather")),
                                 device="cpu")
    toks = greedy_decode(cfg, pt, _tbatch(batch), NEW, T + NEW + PAD,
                         tables)
    assert toks == [list(r) for r in zip(*_ref_greedy("act", "stacked")[0])]


# =========================================================================
# the step: pos as a tensor, no host read, read-only cross K/V
# =========================================================================
def _smoke_tables():
    cfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), lut_sites="all")
    params = init_params(cfg, seed=3, device="cpu")
    calib = np.random.default_rng(0).normal(size=20000) * 3
    tables = build_serving_plans(cfg, calib).tables_for_model(device="cpu")
    return dataclasses.replace(cfg, lut_activation=True), params, tables


def test_tensor_pos_gives_int_pos_bits():
    """On the bf16 smoke config with every site in scope, ``pos`` as a
    0-d tensor gives the bits of ``pos`` as an int, logits and cache."""
    cfg, params, tables = _smoke_tables()
    batch = _tbatch(t_model_batch(cfg, np.random.default_rng(2), 2, 6))
    _, cache = prefill(params, cfg, batch, 8, tables)
    outs = []
    for p in (6, torch.tensor(6)):
        c = clone_state(cache)
        lg, c = decode_step(params, cfg, c, batch["tokens"][:, :1], p,
                            tables)
        outs.append((lg, c))
    (li, ci), (lt, ct_) = outs
    assert torch.equal(li, lt)
    for name in ci:
        assert torch.equal(ci[name], ct_[name]), name
    assert ci["k"][:, :, 6].abs().sum() > 0


def _refuse(name):
    def refused(*a, **kw):
        raise AssertionError(f"{name} on the decode step")
    return refused


def test_decode_step_has_no_host_sync(monkeypatch):
    """An encdec decode step with every site in scope calls nothing that
    reads a tensor back to the host (``item``, ``tolist``, truth values,
    ``nonzero``); it writes the self K/V at ``pos`` in place and leaves
    the cross K/V bit for bit as prefill wrote them."""
    cfg, params, tables = _smoke_tables()
    batch = _tbatch(t_model_batch(cfg, np.random.default_rng(2), 2, 6))
    _, cache = prefill(params, cfg, batch, 9, tables)
    ptrs = {n: t.data_ptr() for n, t in state_leaves(cache)}
    before = clone_state(cache)
    for owner, names in ((torch.Tensor, ("item", "tolist", "__bool__",
                                         "nonzero")),
                         (torch, ("nonzero",))):
        for name in names:
            monkeypatch.setattr(owner, name, _refuse(name))
    lg, out = decode_step(params, cfg, cache, batch["tokens"][:, :1],
                          torch.tensor(6), tables)
    monkeypatch.undo()
    assert lg.shape == (2, 1, cfg.vocab_size) and out is cache
    assert {n: t.data_ptr() for n, t in state_leaves(cache)} == ptrs
    for name in ("xk", "xv"):
        assert torch.equal(cache[name].view(torch.int16),
                           before[name].view(torch.int16)), name
    for name in ("k", "v"):
        changed = (cache[name] != before[name]).flatten(3).any(-1)
        assert changed[:, :, 6].all() and not changed[:, :, :6].any()


# =========================================================================
# the launcher
# =========================================================================
def test_launcher_serves_whisper_on_cpu(capsys):
    """``--arch whisper-small``: the batch carries its frames, decoding
    runs from ``T`` through the padded cache, the tokens are
    ``greedy_decode``'s on the same tables, and ``--kv-int8`` does not
    apply (the reference's launcher skips it for encdec): logged."""
    argv = ["--device", "cpu", "--arch", ARCH, "--batch", "2",
            "--prompt-len", "7", "--new-tokens", "3", "--lut-act",
            "--calib-steps", "1", "--lut-backend", "gather", "--kv-int8"]
    out = launcher.main(argv)
    printed = capsys.readouterr().out
    assert f"{ARCH}-smoke: parameters: " in printed
    assert "--kv-int8 does not apply to the encdec family" in printed
    assert out["start"] == 7 and out["replay_s"] is None
    args = launcher.parse_args(argv)
    cfg, params, batch, rng = launcher.setup(args)
    assert batch["frames"].shape == (2, F, 64)
    assert batch["frames"].dtype == torch.float32
    plans = launcher.build_plans(args, cfg, params, rng, log=lambda m: None)
    assert {"mlp"} <= set(plans.sites) and plans.sites["mlp"].per_layer
    tables = launcher.serving_tables(args, plans, "cpu", log=lambda m: None)
    assert out["tokens"] == greedy_decode(plans.patched_config(cfg), params,
                                          batch, 3, lut_tables=tables)


def test_launcher_default_arch_is_the_references():
    assert launcher.parse_args([]).arch == "phi4-mini-3.8b"
