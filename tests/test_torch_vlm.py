"""The port's vlm family (``phi-3-vision-4.2b``: the dense decoder after a
stubbed image prefix of ``n_patches`` projected patch embeddings) against
the JAX reference on the CPU: configs, the ``patch_proj`` bridge, the
cache, the batch draws, prefill with patches and greedy decode from
position ``n_patches + T`` on the float32 smoke config (4 patches), exact
and with the reference's tables, calibration capture and the ``mlp``
slabs, ``pos`` as a tensor, and the launcher.

Decoding starts at ``n_patches + T``, the reference's
``verify_backend_equivalence`` convention; its launcher decodes from ``T``
over the patch slots (ROADMAP queue C), which the port does not copy.

Tolerances, as ``tests/test_torch_decode.py``: float32 outputs of the two
frameworks agree to about 1e-6 relative, held within ``ATOL`` = 2e-5;
with LUT tables an input that close to a quantizer bin edge can land one
output level away, so logits are held within ``LUT_ATOL`` = 5e-4; greedy
tokens must be identical.  Histograms may move a sample across a bin edge
for the same reason (at most ``HIST_MOVE_FRAC`` of a key's samples).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import calibration_from_capture as j_from_capture
from repro.calib import capture_calibration as j_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import model_batch as j_model_batch
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro.serve import prefill as j_prefill
from repro.serve.kvcache import cache_specs as j_cache_specs
from repro.serve.plans import _greedy_decode as j_greedy
from repro.serve.plans import verify_backend_equivalence as j_verify
from repro_torch import configs as tconfigs
from repro_torch import ioutil
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import CalibrationSet as TCalib
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import model_batch as t_model_batch
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.launch import serve as launcher
from repro_torch.nn import DecoderParams, init_params
from repro_torch.serve import (
    build_serving_plans,
    decode_start,
    decode_step,
    greedy_decode,
    init_cache,
    prefill,
)

ARCH = "phi-3-vision-4.2b"
B, T, NEW = 2, 12, 4
P = 4                    # the smoke config's patches
PAD = 5                  # max_seq past the prefix and the new tokens
ATOL = 2e-5
LUT_ATOL = 5e-4
HIST_MOVE_FRAC = 0.01


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
    batch of ``T`` tokens after ``P`` patches (the reference's
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


def _port_greedy(cfg, params, batch, tables):
    tb = _tbatch(batch)
    start = decode_start(cfg, tb)
    logits, cache = prefill(params, cfg, tb, start + NEW + PAD, tables)
    out, lgs = [], [logits[:, -1].numpy()]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(NEW):
        out.append(tok[:, 0].tolist())
        logits, cache = decode_step(params, cfg, cache, tok, start + i,
                                    tables)
        lgs.append(logits[:, -1].numpy())
        tok = logits[:, -1].argmax(-1)[:, None]
    return out, lgs


@functools.lru_cache(maxsize=None)
def _ref_greedy(sites, form):
    cj, _, pj, _, batch, plans = _model(sites)
    if form == "exact":
        cfg, tables = cj, None
    else:
        cfg = plans.patched_config(cj)
        tables = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
    return j_greedy(cfg, pj, {k: jnp.asarray(v) for k, v in batch.items()},
                    P + T, NEW, P + T + NEW + PAD, tables)


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


# =========================================================================
# configs, parameters, the cache and the batch
# =========================================================================
def test_config_and_smoke_config_equal_reference():
    full = tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert (full.family, full.n_patches, full.d_head, full.n_kv_heads) == (
        "vlm", 256, 96, 32)
    smoke = tconfigs.smoke_config(full)
    assert dataclasses.asdict(smoke) == dataclasses.asdict(
        jconfigs.smoke_config(jconfigs.get_config(ARCH)))
    assert smoke.n_patches == P


def test_params_bridge_is_bit_exact_with_patch_proj():
    cj = jconfigs.smoke_config(jconfigs.get_config(ARCH))
    ct = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    pj = to_np(j_init(cj, jax.random.PRNGKey(1)))
    pt = params_from_jax(pj, ct, device="cpu")
    assert isinstance(pt, DecoderParams)
    assert pt.patch_proj.shape == (64, 64)
    assert pt.patch_proj.dtype == torch.bfloat16
    assert pj["patch_proj"].view(np.int16).tobytes() == \
        pt.patch_proj.view(torch.int16).numpy().tobytes()
    for name, t in pt.blocks.items():
        assert pj["blocks"][name].view(np.int16).tobytes() == \
            t.view(torch.int16).numpy().tobytes(), name


def test_full_width_parameters():
    """3.83 G parameters at full width (counted on the meta device)."""
    meta = DecoderParams(tconfigs.get_config(ARCH), device="meta")
    assert meta.patch_proj.shape == (3072, 3072)
    assert meta.blocks["w_in"].shape == (32, 3072, 16384)
    assert sum(p.numel() for p in meta.parameters()) == 3_830_516_736


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_init_cache_matches_reference_specs(kv_dtype):
    cfg = tconfigs.get_config(ARCH)
    cache = init_cache(cfg, 4, 336, device="meta",
                       kv_dtype="int8" if kv_dtype == "int8" else None)
    spec = j_cache_specs(jconfigs.get_config(ARCH), 4, 336,
                         kv_dtype=kv_dtype)
    assert sorted(cache) == sorted(spec)
    for name, s in spec.items():
        assert tuple(cache[name].shape) == s.shape, name
        assert str(cache[name].dtype).split(".")[-1] == s.dtype.name


def test_model_batch_draws_the_references_numbers():
    """Tokens, then ``rng.normal`` patches cast to float32, bit for bit,
    batch after batch: both packages calibrate on the same numbers."""
    cfg = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    jcfg = jconfigs.smoke_config(jconfigs.get_config(ARCH))
    for a, b in zip(t_batches(cfg, 3, batch_size=2, seq_len=7, seed=4),
                    j_batches(jcfg, 3, batch_size=2, seq_len=7, seed=4)):
        assert sorted(a) == sorted(b) == ["patches", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k
    one = t_model_batch(cfg, np.random.default_rng(0), 2, 7)
    assert one["patches"].shape == (2, P, 64)


@pytest.mark.parametrize("max_seq", [None, P + T + NEW + PAD])
def test_prefill_keeps_the_prefix_and_pads(max_seq):
    """The prefill cache holds ``P + T`` entries (the patches first),
    padded with zeros to ``max_seq`` when that is longer: the reference's
    cache, entry for entry."""
    cj, ct, pj, pt, batch, _ = _model()
    lj, cache_j = jax.jit(lambda p, b: j_prefill(p, cj, b, max_seq=max_seq))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, cache_t = prefill(pt, ct, _tbatch(batch), max_seq)
    n = max_seq or P + T
    for name in ("k", "v"):
        assert cache_t[name].shape == (ct.n_layers, B, n, ct.n_kv_heads,
                                       ct.d_head)
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=0,
                                   atol=ATOL)
        assert not cache_t[name][:, :, P + T:].any()
        assert cache_t[name][:, :, :P].abs().sum() > 0
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)


# =========================================================================
# prefill with patches and greedy decode against the reference
# =========================================================================
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
    the plain K3, the other sites through the plain K4), against the
    reference's gather decode on the same plans; the tokens are also the
    reference's ``verify_backend_equivalence`` tokens (its gather, Pallas
    and fused Pallas decodes agree)."""
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
    got = _port_greedy(ct_l, pt, batch, tt)
    _compare(ref, got, LUT_ATOL)
    if sites == "act" and form != "fused":
        verified = j_verify(cj, pj, plans, batch, NEW,
                            max_seq=P + T + NEW + PAD, plan_exec=form)
        assert [list(r) for r in zip(*got[0])] == verified


def test_greedy_decode_takes_the_batch():
    """``serve.greedy_decode`` on a batch dict decodes from ``P + T``,
    as the reference's harness does."""
    _, ct, _, pt, batch, plans = _model()
    tt = tables_from_jax(to_np(plans.tables_for_model(backend="gather",
                                                      mesh=False)),
                         device="cpu")
    ct_l = dataclasses.replace(ct, lut_activation=True)
    toks = greedy_decode(ct_l, pt, _tbatch(batch), NEW,
                         P + T + NEW + PAD, tt)
    want = _ref_greedy("act", "stacked")[0]
    assert toks == [list(r) for r in zip(*want)]


# =========================================================================
# calibration and the mlp slabs
# =========================================================================
def test_capture_matches_reference():
    """``L{i}/mlp`` over the patches and the tokens: the reference's keys,
    sample counts and histograms."""
    cj, ct, pj, pt, *_ = _model()
    cap_j = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2,
                                              seq_len=9, seed=1))
    cap_t = t_capture_model(pt, ct, t_batches(ct, 2, batch_size=2,
                                              seq_len=9, seed=1))
    want = sorted(f"L{l}/mlp" for l in range(ct.n_layers))
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == want
    assert cap_t.hists["L0/mlp"].sum() == 2 * 2 * (P + 9) * ct.d_ff
    assert (cap_t.n_samples, cap_t.n_batches) == (cap_j.n_samples,
                                                  cap_j.n_batches)
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        moved = np.abs(ht - hj).sum() / 2
        assert ht.sum() == hj.sum() and moved <= HIST_MOVE_FRAC * hj.sum()
        np.testing.assert_allclose(cap_t.ranges[key], cap_j.ranges[key],
                                   rtol=1e-5)


def _flat(tree, prefix=""):
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
def test_mlp_slabs_equal_reference(form):
    cj, ct, pj, *_ = _model()
    calib_j = j_from_capture(j_capture_model(
        pj, cj, j_batches(cj, 1, batch_size=2, seq_len=8, seed=1)))
    calib_t = TCalib(masks=calib_j.masks, w_in=calib_j.w_in,
                     x_lo=calib_j.x_lo, x_hi=calib_j.x_hi,
                     hists=calib_j.hists, ranges=calib_j.ranges)
    pj_, pt_ = j_build(cj, calib_j), build_serving_plans(ct, calib_t)
    assert pj_.total_cost == pt_.total_cost and pt_.sites["mlp"].per_layer
    if form == "fused":
        pairs = [(pj_.tables_for_model(backend="pallas", kernel="fused",
                                       mesh=False)["multi"],
                  pt_.tables_for_model(backend="cuda", kernel="fused",
                                       device="cpu")["multi"])]
    else:
        pairs = [(pj_.tables_for_model(backend=bj, plan_exec=form,
                                       mesh=False)["sites"]["mlp"],
                  pt_.tables_for_model(backend=bt, plan_exec=form,
                                       device="cpu")["sites"]["mlp"])
                 for bj, bt in (("gather", "gather"), ("pallas", "cuda"))]
    for tj, tt in pairs:
        fj, ft = _flat(to_np(tj)), _flat(tt)
        assert sorted(fj) == sorted(ft) and fj
        assert ioutil.payload_checksum(ft) == ioutil.payload_checksum(fj)
        for k in fj:
            assert fj[k].tobytes() == ft[k].tobytes(), k


# =========================================================================
# pos as a tensor, and the launcher
# =========================================================================
def test_tensor_pos_gives_int_pos_bits():
    """On the bf16 smoke config with every site in scope, ``pos`` as a
    0-d tensor gives the bits of ``pos`` as an int, logits and cache."""
    cfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), lut_sites="all")
    params = init_params(cfg, seed=3, device="cpu")
    calib = np.random.default_rng(0).normal(size=20000) * 3
    tables = build_serving_plans(cfg, calib).tables_for_model(device="cpu")
    cfg = dataclasses.replace(cfg, lut_activation=True)
    batch = _tbatch(t_model_batch(cfg, np.random.default_rng(2), 2, 6))
    start = decode_start(cfg, batch)
    assert start == P + 6
    _, cache = prefill(params, cfg, batch, start + 2, tables)
    outs = []
    for p in (start, torch.tensor(start)):
        c = {k: v.clone() for k, v in cache.items()}
        lg, c = decode_step(params, cfg, c, batch["tokens"][:, :1], p,
                            tables)
        outs.append((lg, c))
    (li, ci), (lt, ct_) = outs
    assert torch.equal(li, lt)
    for name in ci:
        assert torch.equal(ci[name], ct_[name]), name
    assert ci["k"][:, :, start].abs().sum() > 0


def test_launcher_decodes_after_the_patches(monkeypatch, capsys):
    """``--arch phi-3-vision-4.2b``: the batch carries its patches, the
    decode runs at positions ``P + T ..`` (not ``T``, where the patches
    lie), and the tokens are ``greedy_decode``'s on the same tables."""
    real = launcher.decode_fn
    seen = []

    def spy(params, cfg, tables):
        step = real(params, cfg, tables)

        def run(cache, tok, pos):
            seen.append((pos, cache["k"].shape[2]))
            return step(cache, tok, pos)
        return run

    monkeypatch.setattr(launcher, "decode_fn", spy)
    argv = ["--device", "cpu", "--arch", ARCH, "--batch", "2",
            "--prompt-len", "7", "--new-tokens", "3", "--lut-act",
            "--calib-steps", "1", "--lut-backend", "gather"]
    out = launcher.main(argv)
    printed = capsys.readouterr().out
    assert f"{ARCH}-smoke: parameters: " in printed
    assert f"prefill 2x7 after {P} patch embeddings" in printed
    assert seen == [(P + 7 + i, P + 7 + 3) for i in range(3)]
    args = launcher.parse_args(argv)
    cfg, params, batch, rng = launcher.setup(args)
    assert batch["patches"].shape == (2, P, 64)
    plans = launcher.build_plans(args, cfg, params, rng, log=lambda m: None)
    tables = launcher.serving_tables(args, plans, "cpu", log=lambda m: None)
    assert out["tokens"] == greedy_decode(plans.patched_config(cfg), params,
                                          batch, 3, lut_tables=tables)


def test_launcher_refuses_kv_int8(capsys):
    """``--kv-int8`` would replay only the tokens into the int8 cache and
    lose the image prefix: refused, naming why."""
    with pytest.raises(SystemExit) as info:
        launcher.main(["--device", "cpu", "--arch", ARCH, "--kv-int8"])
    assert info.value.code == 2
    assert "ingests tokens only" in capsys.readouterr().err
    args = launcher.parse_args(["--device", "cpu", "--arch", ARCH,
                                "--kv-int8"])
    cfg = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    with pytest.raises(ValueError, match="patch embeddings"):
        launcher.kv_int8_applies(args, cfg)
