"""The reference's three other dense configurations in the port:
``nemotron-4-15b`` (relu2 without a gate, d_ff 24576), ``phi4-mini-3.8b``
(swiglu, the reference launcher's default) and ``deepseek-67b`` (swiglu,
95 layers at d_model 8192), against the JAX reference on the CPU: the
configs, their parameter counts (the config's ``n_params`` and the
parameter definitions leaf for leaf at full width, on the meta device),
the smoke configs, and prefill plus 4 greedy tokens on the float32 smoke
configs exact and in forms (a) stacked, (b) unrolled and (d) fused (the
MLP through K3's plain version: nemotron's relu2 table without a gate,
the gated product for the other two).

Tolerances, as ``tests/test_torch_decode.py``: float32 logits of the two
frameworks are held within ``ATOL`` = 2e-5; with LUT tables an input
that close to a quantizer bin edge can land one output level away, so
logits are held within ``LUT_ATOL`` = 5e-4; greedy tokens must be
identical.
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
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.nn.transformer import param_defs as j_param_defs
from repro.serve import build_serving_plans as j_build
from repro.serve import prefill as j_prefill
from repro.serve.plans import _greedy_decode as j_greedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.nn import DecoderParams
from repro_torch.serve import decode_step, prefill

ARCHS = ("nemotron-4-15b", "phi4-mini-3.8b", "deepseek-67b")
B, T, NEW, PAD = 2, 10, 4, 3
ATOL = 2e-5
LUT_ATOL = 5e-4
# (family, activation, gated, full-width parameters)
EXPECT = {"nemotron-4-15b": ("dense", "relu2", False, 15_628_376_064),
          "phi4-mini-3.8b": ("dense", "swiglu", True, 4_450_618_368),
          "deepseek-67b": ("dense", "swiglu", True, 67_425_001_472)}


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


@functools.lru_cache(maxsize=None)
def _model(arch):
    """Both packages' float32 smoke model on the reference's parameters, a
    prompt batch, and the reference's per-site plans for the ``mlp``."""
    cj = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)),
                             dtype="float32")
    ct = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                             dtype="float32")
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(0).integers(1, ct.vocab_size, (B, T),
                                               dtype=np.int32)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    return cj, ct, pj, pt, tokens, j_build(cj, calib)


@functools.lru_cache(maxsize=None)
def _ref_greedy(arch, form):
    cj, _, pj, _, tokens, plans = _model(arch)
    if form == "exact":
        cfg, tables = cj, None
    else:
        cfg = plans.patched_config(cj)
        tables = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
    return j_greedy(cfg, pj, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW + PAD, tables)


def _port_greedy(cfg, params, tokens, tables):
    batch = {"tokens": torch.as_tensor(tokens).long()}
    logits, cache = prefill(params, cfg, batch, T + NEW + PAD, tables)
    out, lgs = [], [logits[:, -1].numpy()]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(NEW):
        out.append(tok[:, 0].tolist())
        logits, cache = decode_step(params, cfg, cache, tok, T + i, tables)
        lgs.append(logits[:, -1].numpy())
        tok = logits[:, -1].argmax(-1)[:, None]
    return out, lgs


def _flat_shapes(tree, prefix=""):
    """``{dotted name: shape}`` of a reference ``param_defs`` tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_smoke_config_equal_reference(arch):
    full, ref = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(ref)
    family, act, _, _ = EXPECT[arch]
    assert (full.family, full.activation) == (family, act)
    assert full.n_params() == ref.n_params()
    assert full.n_active_params() == ref.n_active_params()
    assert dataclasses.asdict(tconfigs.smoke_config(full)) == \
        dataclasses.asdict(jconfigs.smoke_config(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameters(arch):
    """The reference's parameter definitions, leaf for leaf, counted on
    the meta device: nemotron's ``w_in`` is ``d_ff`` wide (no gate), the
    swiglu models' ``2 d_ff`` ([gate | up])."""
    cfg = tconfigs.get_config(arch)
    meta = DecoderParams(cfg, device="meta")
    want = _flat_shapes(j_param_defs(jconfigs.get_config(arch)))
    got = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    assert got == want
    _, _, gated, n = EXPECT[arch]
    assert meta.blocks["w_in"].shape == (
        cfg.n_layers, cfg.d_model, (2 if gated else 1) * cfg.d_ff)
    assert sum(p.numel() for p in meta.parameters()) == sum(
        math.prod(s) for s in want.values()) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cj, ct, pj, pt, tokens, _ = _model(arch)
    max_seq = T + NEW + PAD
    lj, cache_j = jax.jit(lambda p, b: j_prefill(p, cj, b, max_seq=max_seq))(
        pj, {"tokens": jnp.asarray(tokens)})
    lt, cache_t = prefill(pt, ct, {"tokens": torch.as_tensor(tokens).long()},
                          max_seq)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    for name in ("k", "v"):
        assert cache_t[name].shape == cache_j[name].shape
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("form", ["exact", "stacked", "unrolled", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, form):
    """4 greedy tokens: exact, and on the reference's per-site plans in
    forms (a) stacked, (b) unrolled and (d) fused (the plain K3, gated or
    not, held against the reference's stacked gather decode)."""
    cj, ct, pj, pt, tokens, plans = _model(arch)
    if form == "exact":
        _compare(_ref_greedy(arch, "exact"),
                 _port_greedy(ct, pt, tokens, None), ATOL)
        return
    ct_l = dataclasses.replace(ct, lut_activation=True)
    if form == "fused":
        tj = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tj), device="cpu"),
                  backend="gather")
        assert tt["sites"]["mlp"] == {"multi": "mlp"}
        ct_l = dataclasses.replace(ct_l, lut_fuse=True)
        ref = _ref_greedy(arch, "stacked")
    else:
        tj = plans.tables_for_model(backend="gather", mesh=False,
                                    plan_exec=form)
        tt = tables_from_jax(to_np(tj), device="cpu")
        ref = _ref_greedy(arch, form)
    _compare(ref, _port_greedy(ct_l, pt, tokens, tt), LUT_ATOL)
