"""Prefill and greedy decode of the port against the JAX reference on the
float32 smoke config of qwen3-0.6b (2 layers, d_model 64), with the
reference's parameters carried across by ``bridge.params_from_jax`` and,
for the LUT forms, the reference's own serving tables by
``bridge.tables_from_jax``.  Both sides serve on the CPU; the reference's
steps are jitted, as its serving loop runs them.

Tolerances: the two frameworks sum the matmuls, norms and softmax in other
orders (and XLA may contract multiply-adds), so float32 logits agree to
about 1e-6 relative.  With LUT tables, an activation within that distance
of a quantizer bin edge can land one output level away (a step of the
table's span / 1023), which moves logits by up to about 1e-4; greedy
tokens must be identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import capture_calibration as j_capture
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro.serve.plans import _greedy_decode as j_greedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.serve import decode_step, prefill

B, T, NEW = 2, 16, 4
NOLUT_ATOL = 2e-5
LUT_ATOL = 5e-4


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs():
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
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
    shared = j_build(cj, np.random.default_rng(0).normal(size=100000) * 3)
    return cj, ct, pj, pt, tokens, plans, shared


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


def _ref_greedy(cfg, params, tokens, tables):
    return j_greedy(cfg, params, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW, tables)


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_params_bridge_is_bit_exact(setup):
    _, _, pj, pt, *_ = setup
    for name, t in pt.named_parameters():
        leaf = pj[name] if "." not in name else pj["blocks"][name[7:]]
        assert np.asarray(leaf).tobytes() == t.detach().numpy().tobytes()


def test_bf16_params_bridge_is_bit_exact():
    cj = jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b"))
    ct = tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b"))
    pj = j_init(cj, jax.random.PRNGKey(1))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    assert pt.blocks["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        np.asarray(pj["blocks"]["w_in"]).view(np.int16),
        pt.blocks["w_in"].view(torch.int16).numpy())


def test_plain_decode_matches_reference(setup):
    cj, ct, pj, pt, tokens, *_ = setup
    _compare(_ref_greedy(cj, pj, tokens, None),
             _port_greedy(ct, pt, tokens, None), NOLUT_ATOL)


@pytest.mark.parametrize("form", ["stacked", "unrolled", "shared"])
def test_lut_decode_matches_reference(setup, form):
    cj, ct, pj, pt, tokens, plans, shared = setup
    src = shared if form == "shared" else plans
    exec_ = "unrolled" if form == "unrolled" else "stacked"
    tj = src.tables_for_model(backend="gather", plan_exec=exec_, mesh=False)
    tt = tables_from_jax(to_np(tj), device="cpu")
    ct_l = dataclasses.replace(ct, lut_activation=True)
    _compare(_ref_greedy(src.patched_config(cj), pj, tokens, tj),
             _port_greedy(ct_l, pt, tokens, tt), LUT_ATOL)


def test_fused_form_plain_path_matches_reference(setup):
    """``--lut-fuse`` on the port's gather backend: the plain K3 over the
    reference's bit-packed multi-site super-slab, held against the
    reference's own decode on the same plans."""
    cj, ct, pj, pt, tokens, plans, _ = setup
    tj = plans.tables_for_model(backend="pallas", kernel="fused",
                                mesh=False)
    tt = dict(tables_from_jax(to_np(tj), device="cpu"), backend="gather")
    assert "multi" in tt and tt["sites"]["mlp"] == {"multi": "mlp"}
    ct_f = dataclasses.replace(ct, lut_activation=True, lut_fuse=True)
    ref = _ref_greedy(plans.patched_config(cj), pj, tokens,
                      plans.tables_for_model(backend="gather", mesh=False))
    _compare(ref, _port_greedy(ct_f, pt, tokens, tt), LUT_ATOL)
