"""RWKV6 (the ssm family, ``rwkv6-3b``) of the port against the JAX
reference on the CPU: config, parameter bridge, the chunked WKV (K8's
plain version), time and channel mix, recurrent state, and prefill plus
greedy decode of the float32 smoke config with and without LUT tables.

Tolerances, each the reference's own where it has one:
* plain ``wkv_chunked`` vs the reference's ``wkv_chunked``: ``rtol = atol
  = 1e-5`` (the reference's kernel-vs-chunked tolerance); vs the
  sequential oracle ``wkv_scan_ref`` and the reference's ``ops.wkv``
  (Pallas, interpret): ``3e-4`` (tests/test_kernels.py) — the chunked and
  sequential forms associate the decays differently;
* time and channel mix: ``rtol = atol = 1e-5``, as for ``wkv_chunked``
  (float32 matmuls and the WKV summed in other orders; the per-head norm
  after the WKV scales an absolute error of the WKV output up);
* decode: logits within ``NOLUT_ATOL`` exact, ``LUT_ATOL`` with tables (an
  input within ~1e-6 of a quantizer bin edge may land one level away);
  greedy tokens identical.
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
from repro.kernels.ops import wkv as j_ops_wkv
from repro.nn import init_params as j_init
from repro.nn import ssm as jssm
from repro.serve import build_serving_plans as j_build
from repro.serve.kvcache import init_cache as j_init_cache
from repro.serve.plans import _greedy_decode as j_greedy
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.kernels import launch_counts
from repro_torch.nn import RWKVParams
from repro_torch.nn import ssm as tssm
from repro_torch.serve import decode_step, init_cache, prefill

B, T, NEW = 2, 16, 4
NOLUT_ATOL = 2e-5
LUT_ATOL = 5e-4
WKV_SHAPES = [(64, 16, False), (64, 16, True), (48, 16, False),
              (32, 8, True), (16, 16, False)]


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(dtype="float32", **kw):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("rwkv6-3b")), dtype=dtype,
        **kw)
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("rwkv6-3b")), dtype=dtype,
        **kw)
    return cj, ct


@pytest.fixture(scope="module")
def setup():
    cj, ct = _cfgs()
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(0).integers(1, cj.vocab_size, (B, T),
                                               dtype=np.int32)
    return cj, ct, pj, pt, tokens


def test_config_and_smoke_config_equal_reference():
    full_j = jconfigs.get_config("rwkv6-3b")
    full_t = tconfigs.get_config("rwkv6-3b")
    assert dataclasses.asdict(full_j) == dataclasses.asdict(full_t)
    assert (full_t.n_layers, full_t.d_model, full_t.d_ff,
            full_t.vocab_size, full_t.rwkv_head_dim) == (32, 2560, 8960,
                                                         65536, 64)
    assert dataclasses.asdict(jconfigs.smoke_config(full_j)) == \
        dataclasses.asdict(tconfigs.smoke_config(full_t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_bridge_is_bit_exact(dtype):
    cj, ct = _cfgs(dtype)
    pj = j_init(cj, jax.random.PRNGKey(1))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    assert isinstance(pt, RWKVParams)
    ib = np.int16 if dtype == "bfloat16" else np.int32
    tb = torch.int16 if dtype == "bfloat16" else torch.int32
    named = dict(pt.named_parameters())
    assert len(named) == 3 + len(pj["blocks"])
    for name, t in named.items():
        leaf = pj[name] if "." not in name else pj["blocks"][name[7:]]
        np.testing.assert_array_equal(np.asarray(leaf).view(ib),
                                      t.detach().view(tb).numpy(),
                                      err_msg=name)


def _wkv_inputs(t, chunk, strong, b=2, h=3, n=16):
    rng = np.random.default_rng(t + chunk)
    q, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32)
               for _ in range(3))
    hi = 0.7 if strong else -1.0
    log_w = (-np.exp(rng.uniform(-3, hi, size=(b, t, h, n)))).astype(
        np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    return q, k, v, log_w, u


@pytest.mark.parametrize("t,chunk,strong", WKV_SHAPES)
def test_wkv_chunked_matches_reference(t, chunk, strong):
    """Plain ``wkv_chunked`` against the reference's ``wkv_chunked``
    (1e-5), its sequential oracle and its Pallas kernel in interpret mode
    (3e-4); the port's own oracle against the reference's."""
    args = _wkv_inputs(t, chunk, strong)
    targs = [torch.from_numpy(a) for a in args]
    before = launch_counts()["wkv"]
    y, s = tssm.wkv_chunked(*targs, chunk=chunk)
    assert launch_counts()["wkv"] == before   # CPU: the plain version
    yc, sc = jssm.wkv_chunked(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sc), rtol=1e-5,
                               atol=1e-5)
    for yr, sr in (jssm.wkv_scan_ref(*map(jnp.asarray, args)),
                   j_ops_wkv(*map(jnp.asarray, args), chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=3e-4,
                                   atol=3e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), rtol=3e-4,
                                   atol=3e-4)
    ys, ss = tssm.wkv_scan_ref(*targs)
    yj, sj = jssm.wkv_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(ys.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ss.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("t,chunk", [(48, 16), (20, 8)])
def test_wkv_chunked_from_a_given_state(t, chunk):
    """``state=`` (a prompt continued from a recurrent state), ragged T:
    equal to the reference's ``wkv_chunked(state=...)`` and to running
    the two halves back to back."""
    q, k, v, log_w, u = _wkv_inputs(t, chunk, True)
    s0 = np.random.default_rng(9).normal(size=(2, 3, 16, 16)).astype(
        np.float32)
    y, s = tssm.wkv_chunked(*map(torch.from_numpy, (q, k, v, log_w, u)),
                            chunk=chunk, state=torch.from_numpy(s0))
    yj, sj = jssm.wkv_chunked(*map(jnp.asarray, (q, k, v, log_w, u)),
                              chunk=chunk, state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)
    h = t // 2
    tq = [torch.from_numpy(a) for a in (q, k, v, log_w)]
    y1, s1 = tssm.wkv_chunked(*(a[:, :h] for a in tq), torch.from_numpy(u),
                              chunk=chunk, state=torch.from_numpy(s0))
    y2, s2 = tssm.wkv_chunked(*(a[:, h:] for a in tq), torch.from_numpy(u),
                              chunk=chunk, state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), rtol=3e-4, atol=3e-4)


def test_wkv_decode_step_matches_reference():
    q, k, v, log_w, u = (a[:, 0] if a.ndim == 4 else a
                         for a in _wkv_inputs(16, 16, False))
    s0 = np.random.default_rng(4).normal(size=(2, 3, 16, 16)).astype(
        np.float32)
    y, s = tssm.wkv_decode_step(*map(torch.from_numpy,
                                     (q, k, v, log_w, u, s0)))
    yj, sj = jssm.wkv_decode_step(*map(jnp.asarray, (q, k, v, log_w, u, s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)


def _layer(params_j, params_t, i=0):
    return ({k: v[i] for k, v in params_j["blocks"].items()},
            params_t.layer(i))


@pytest.mark.parametrize("t", [1, 5, 16])
def test_time_mix_matches_reference(setup, t):
    """Time mix from a zero state (prompt) and from a random state
    (decode, T == 1)."""
    cj, ct, pj, pt, _ = setup
    rng = np.random.default_rng(t)
    x = rng.normal(size=(B, t, cj.d_model)).astype(np.float32)
    x_last = rng.normal(size=(B, 1, cj.d_model)).astype(np.float32)
    h, n = cj.d_model // cj.rwkv_head_dim, cj.rwkv_head_dim
    s0 = (rng.normal(size=(B, h, n, n)) * 0.1).astype(np.float32)
    lj, lt = _layer(pj, pt, 1)
    for state in (None, (x_last, s0)):
        kw_j = {} if state is None else dict(
            x_last=jnp.asarray(x_last), wkv_state=jnp.asarray(s0))
        kw_t = {} if state is None else dict(
            x_last=torch.from_numpy(x_last), wkv_state=torch.from_numpy(s0))
        oj, (axj, wj) = jssm.rwkv_time_mix(lj, jnp.asarray(x), cj, **kw_j)
        ot, (axt, wt) = tssm.rwkv_time_mix(lt, torch.from_numpy(x), ct,
                                           **kw_t)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(axt.numpy(), np.asarray(axj))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                                   atol=1e-5)


def test_channel_mix_matches_reference(setup):
    cj, ct, pj, pt, _ = setup
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, 7, cj.d_model)).astype(np.float32)
    x_last = rng.normal(size=(B, 1, cj.d_model)).astype(np.float32)
    lj, lt = _layer(pj, pt, 0)
    for kw in ({}, {"x_last": x_last}):
        oj, fj = jssm.rwkv_channel_mix(
            lj, jnp.asarray(x), cj,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        ot, ft = tssm.rwkv_channel_mix(
            lt, torch.from_numpy(x), ct,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference(dtype):
    cj, ct = _cfgs(dtype)
    cj_ = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       j_init_cache(cj, 3, 8))
    got = init_cache(ct, 3, 8, device="cpu")   # bf16 default, as the ref
    assert sorted(got) == sorted(cj_) == ["att_x", "ffn_x", "wkv"]
    for k, (shape, dt) in cj_.items():
        assert tuple(got[k].shape) == shape
        assert str(got[k].dtype).replace("torch.", "") == dt
        assert not got[k].any()


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
    return out, lgs, cache


def _compare(ref, got, atol):
    (rt, rl), (gt, gl, _) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def _ref_greedy(cfg, params, tokens, tables):
    return j_greedy(cfg, params, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW, tables)


def test_plain_decode_matches_reference(setup):
    cj, ct, pj, pt, tokens = setup
    got = _port_greedy(ct, pt, tokens, None)
    _compare(_ref_greedy(cj, pj, tokens, None), got, NOLUT_ATOL)
    state = got[2]
    assert state["wkv"].dtype == torch.float32
    assert state["att_x"].dtype == pt.embed.dtype


@pytest.mark.parametrize("sites, form", [("act", "stacked"),
                                         ("act", "unrolled"),
                                         ("all", "stacked"),
                                         ("all", "fused")])
def test_lut_decode_matches_reference(setup, sites, form):
    """Per-layer tables for the ``ffn`` site (``act``), and for ``ffn`` and
    ``norm_rsqrt`` (``all``); ``fused`` is the super-slab on the gather
    backend (plain K3 non-gated for ``ffn``, plain K4 for
    ``norm_rsqrt``)."""
    _, _, pj, pt, tokens = setup
    cj, ct = _cfgs(lut_sites=sites)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    plans = j_build(cj, calib)
    want = ["ffn"] if sites == "act" else ["ffn", "norm_rsqrt"]
    assert sorted(plans.sites) == want
    assert all(sp.per_layer for sp in plans.sites.values())
    exec_ = "unrolled" if form == "unrolled" else "stacked"
    tj = plans.tables_for_model(backend="gather", plan_exec=exec_,
                                mesh=False)
    ref = _ref_greedy(plans.patched_config(cj), pj, tokens, tj)
    ct_l = dataclasses.replace(ct, lut_activation=True)
    if form == "fused":
        tp = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tp), device="cpu"),
                  backend="gather")
        ct_l = dataclasses.replace(ct_l, lut_fuse=True)
    else:
        tt = tables_from_jax(to_np(tj), device="cpu")
    _compare(ref, _port_greedy(ct_l, pt, tokens, tt), LUT_ATOL)


def test_capture_keys_match_reference(setup):
    """Calibration capture over the rwkv forward keys every per-layer site
    (``ffn``, ``norm_rsqrt`` under ``all``) as the reference does."""
    from repro.calib import capture_model as j_capture_model
    from repro_torch.calib import capture_model as t_capture_model
    from repro_torch.calib import synthetic_batches as t_batches

    _, _, pj, pt, _ = setup
    cj, ct = _cfgs(lut_sites="all")
    cap_j = j_capture_model(pj, cj, j_batches(cj, 1, batch_size=2,
                                              seq_len=8, seed=3))
    cap_t = t_capture_model(pt, ct, t_batches(ct, 1, batch_size=2,
                                              seq_len=8, seed=3))
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == [
        "L0/ffn", "L0/norm_rsqrt", "L1/ffn", "L1/norm_rsqrt"]
    assert cap_t.domains == cap_j.domains
    for key, hj in cap_j.hists.items():
        assert cap_t.hists[key].sum() == hj.sum()
        assert np.abs(cap_t.hists[key] - hj).sum() / 2 <= 0.01 * hj.sum()
