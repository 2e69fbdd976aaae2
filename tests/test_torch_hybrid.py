"""The port's hybrid family (Griffin / RecurrentGemma, ``recurrentgemma-9b``)
against the JAX reference on the CPU: configs, the parameter bridge on the
nested ``groups`` / ``tail`` tree, the decode state, the RG-LRU and its
log-depth scan, the causal conv, the recurrent block, local attention and
its ring buffer, prefill plus greedy decode of the float32 smoke config
(4 layers: one (rec, rec, attn) group and a one-layer tail, window 8)
exact and with the reference's tables, calibration capture and the
``mlp`` slabs, and a decode step that reads nothing back to the host.

Tolerances:
* float32 blocks (``rg_lru``, ``rg_lru_step``, ``recurrent_block`` and its
  step, windowed ``mha``, ``ring_decode_attend``): ``rtol = atol = 1e-5``.
  The scan associates as ``jax.lax.associative_scan`` does, but matmuls
  and XLA's fused multiply-adds round in other places, about 1e-7
  relative; 1e-5 leaves room for the ``exp`` of a summed ``log a`` over
  64 steps.  The float32 conv within ``CONV_TOL`` = 1e-6 (jitted XLA
  contracts its multiply-adds into fused ones, the port rounds each);
  its state and ``_ring_from_segment`` are exact.
* bf16 promotion (``BF16_STATE_ATOL`` = 1e-6 on float32 results): the
  reference computes ``softplus(lam)`` and ``-8 * softplus`` in bf16, one
  rounding per operation, before the float32 gate widens them; computing
  the softplus in float32 moves ``rg_lru_step`` and the block's LRU state
  by about 2e-3 and fails.  The conv sums in bf16 and is held bit for
  bit.  The block's bf16 output is held within two bf16 ulps at its
  magnitude (``BF16_OUT_ULPS``): ``F.gelu(approximate="tanh")`` rounds
  once where ``jax.nn.gelu`` rounds each operation, one bf16 ulp apart on
  about 5% of inputs.  The reference runs op by op here: under ``jax.jit``
  XLA keeps the step's bf16 conv sum in float32 before its cast (excess
  precision), which the reference's code does not ask for and a card
  running PyTorch does not do.
* decode: logits within ``NOLUT_ATOL`` = 2e-5 exact (``gelu`` differs in
  the last float32 bit between the frameworks), ``LUT_ATOL`` = 5e-4 with
  tables (an input within ~1e-6 of a quantizer bin edge may land one
  level away); greedy tokens identical.
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
from repro.calib import synthetic_batches as j_batches
from repro.nn import attention as jattn
from repro.nn import init_params as j_init
from repro.nn import rglru as jr
from repro.nn.transformer import _ring_from_segment as j_ring
from repro.nn.transformer import hybrid_forward as j_hybrid_forward
from repro.serve import build_serving_plans as j_build
from repro.serve.kvcache import cache_specs as j_cache_specs
from repro.serve.plans import _greedy_decode as j_greedy
from repro_torch import configs as tconfigs
from repro_torch import ioutil
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import CalibrationSet as TCalib
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.launch import serve as launcher
from repro_torch.nn import HybridParams, init_params
from repro_torch.nn import attention as tattn
from repro_torch.nn import rglru as tr
from repro_torch.nn.mlp import project_logits
from repro_torch.nn.transformer import _ring_from_segment, hybrid_forward
from repro_torch.serve import (
    build_serving_plans,
    clone_state,
    decode_step,
    init_cache,
    prefill,
    state_leaves,
)

ARCH = "recurrentgemma-9b"
B, T, NEW = 2, 24, 4          # T > local_window (8): the ring wraps
BLOCK_TOL = 1e-5
CONV_TOL = 1e-6
BF16_STATE_ATOL = 1e-6
BF16_OUT_ULPS = 2
NOLUT_ATOL = 2e-5
LUT_ATOL = 5e-4
HIST_MOVE_FRAC = 0.01


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(dtype="float32", **kw):
    cj = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(ARCH)),
                             dtype=dtype, **kw)
    ct = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(ARCH)),
                             dtype=dtype, **kw)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@functools.lru_cache(maxsize=None)
def _model(sites="act"):
    """Both packages' float32 smoke model on the reference's parameters, a
    prompt of ``T`` tokens and the reference's per-site plans from its
    own capture (``sites="all"``: every site in scope)."""
    cj, ct = _cfgs(lut_sites=sites)
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    tokens = np.random.default_rng(0).integers(1, cj.vocab_size, (B, T),
                                               dtype=np.int32)
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=B, seq_len=T,
                                        seed=1))
    return cj, ct, pj, pt, tokens, j_build(cj, calib)


def _rec_params(dtype="float32", seed=0):
    """Group 0's first recurrent block in both packages."""
    cj, ct = _cfgs(dtype)
    pj = j_init(cj, jax.random.PRNGKey(seed))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    return (cj, ct, jax.tree.map(lambda a: a[0], pj["groups"]["t0_rec"]),
            pt.group(0)["t0_rec"])


# =========================================================================
# configs, parameters and the decode state
# =========================================================================
def test_config_and_smoke_config_equal_reference():
    full = tconfigs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get_config(ARCH))
    assert (full.family, full.n_layers, full.d_rnn, full.local_window) == (
        "hybrid", 38, 4096, 2048)
    assert dataclasses.asdict(tconfigs.smoke_config(full)) == \
        dataclasses.asdict(jconfigs.smoke_config(jconfigs.get_config(ARCH)))


def test_params_bridge_is_bit_exact_on_the_nested_tree():
    """Every leaf of ``groups`` and ``tail`` comes across by its nested
    name (``groups.t0_rec.w_in``, ``groups.t2_attn.wq``, ``tail.t0_rec.
    lam``, …), bf16 bits included."""
    cj = jconfigs.smoke_config(jconfigs.get_config(ARCH))
    ct = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    pj = to_np(j_init(cj, jax.random.PRNGKey(1)))
    pt = params_from_jax(pj, ct, device="cpu")
    assert isinstance(pt, HybridParams)
    named = dict(pt.named_parameters())
    for name in ("groups.t0_rec.w_in", "groups.t2_attn.wq",
                 "groups.m1.w_in", "groups.t1_ln", "tail.t0_rec.lam",
                 "tail.m0.w_out", "tail.m0_ln"):
        assert name in named, name

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    leaves = dict(walk(pj))
    assert sorted(leaves) == sorted(named)
    for name, leaf in leaves.items():
        t = named[name]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
        assert leaf.view(np.int16).tobytes() == \
            t.view(torch.int16).numpy().tobytes(), name


def test_init_params_follows_the_layout():
    """``init_params`` draws every stack: 12 groups and a 2-layer tail at
    full width (on the meta device, no memory), and on the smoke config
    different layers, zeros for the norms."""
    full = tconfigs.get_config(ARCH)
    meta = HybridParams(full, device="meta")
    assert meta.groups.t0_rec.w_a.shape == (12, 4096, 4096)
    assert meta.groups.t2_attn.wk.shape == (12, 4096, 256)
    assert meta.tail.t1_rec.conv_w.shape == (1, 4, 4096)
    assert sum(p.numel() for p in meta.parameters()) == 10_444_664_832
    cfg = dataclasses.replace(tconfigs.smoke_config(full), dtype="float32",
                              n_layers=7)
    params = init_params(cfg, seed=3, device="cpu")
    w = params.groups.t0_rec.w_in
    assert w.shape[0] == 2 and not torch.equal(w[0], w[1])
    assert not params.groups.m0_ln.any() and params.tail.t0_rec.lam.any()


@pytest.mark.parametrize("full", [False, True])
def test_init_cache_matches_reference_specs(full):
    cfg = tconfigs.get_config(ARCH)
    jcfg = jconfigs.get_config(ARCH)
    if not full:
        cfg, jcfg = tconfigs.smoke_config(cfg), jconfigs.smoke_config(jcfg)
    cache = init_cache(cfg, 4, 80, device="meta")
    spec = j_cache_specs(jcfg, 4, 80)
    want = {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(spec)[0]}
    got = dict(state_leaves(cache))
    assert sorted(got) == sorted(want)
    for name, s in want.items():
        assert tuple(got[name].shape) == s.shape, name
        assert str(got[name].dtype).split(".")[-1] == s.dtype.name, name


def test_clone_state_copies_every_nested_tensor():
    cfg = tconfigs.smoke_config(tconfigs.get_config(ARCH))
    cache = init_cache(cfg, 2, 8, device="cpu")
    copy = clone_state(cache)
    a, b = dict(state_leaves(cache)), dict(state_leaves(copy))
    assert sorted(a) == sorted(b) and len(a) == 8
    for name in a:
        assert a[name].data_ptr() != b[name].data_ptr()
        assert torch.equal(a[name], b[name])


# =========================================================================
# the RG-LRU, the conv and the recurrent block (float32)
# =========================================================================
def _seg_inputs(t, d, seed=2, carried=False):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, t, d)).astype(np.float32)
    h = rng.normal(size=(B, d)).astype(np.float32) if carried else None
    return u, h


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [1, 7, 64])
def test_rg_lru_matches_reference(t, carried):
    _, _, jp, tp = _rec_params()
    u, h = _seg_inputs(t, 64, carried=carried)
    hj, lj = jax.jit(jr.rg_lru)(jp, jnp.asarray(u),
                                None if h is None else jnp.asarray(h))
    ht, lt = tr.rg_lru(tp, torch.from_numpy(u),
                       None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("t", [2, 5, 8, 13, 64])
def test_lru_scan_equals_the_sequential_recurrence(t):
    """The log-depth scan is the recurrence ``h_t = a_t h_{t-1} + b_t``
    (held in float64 against a loop)."""
    rng = np.random.default_rng(t)
    la = -rng.uniform(0, 3, size=(2, t, 5))
    b = rng.normal(size=(2, t, 5))
    got = tr._lru_scan(torch.from_numpy(la), torch.from_numpy(b)).numpy()
    h = np.zeros((2, 5))
    for i in range(t):
        h = np.exp(la[:, i]) * h + b[:, i]
        np.testing.assert_allclose(got[:, i], h, rtol=1e-12, atol=1e-12)


def test_rg_lru_step_matches_reference():
    _, _, jp, tp = _rec_params()
    u, _ = _seg_inputs(1, 64)
    h = np.random.default_rng(3).normal(size=(B, 64)).astype(np.float32)
    hj, _ = jax.jit(jr.rg_lru_step)(jp, jnp.asarray(u[:, 0]),
                                    jnp.asarray(h))
    ht, _ = tr.rg_lru_step(tp, torch.from_numpy(u[:, 0]),
                           torch.from_numpy(h))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [1, 7, 64])
def test_causal_conv1d_matches_reference(t, carried):
    _, _, jp, tp = _rec_params()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, t, 64)).astype(np.float32)
    st = rng.normal(size=(B, 3, 64)).astype(np.float32) if carried else None
    oj, sj = jax.jit(jr.causal_conv1d)(
        jp["conv_w"], jnp.asarray(x), None if st is None else jnp.asarray(st))
    ot, stt = tr.causal_conv1d(tp["conv_w"], torch.from_numpy(x),
                               None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=CONV_TOL,
                               atol=CONV_TOL)
    np.testing.assert_array_equal(stt.numpy(), np.asarray(sj))


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [1, 7, 64])
def test_recurrent_block_matches_reference(t, carried):
    cj, ct, jp, tp = _rec_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, t, 64)).astype(np.float32)
    st = None
    if carried:
        st = {"conv": rng.normal(size=(B, 3, 64)).astype(np.float32),
              "lru": rng.normal(size=(B, 64)).astype(np.float32)}
    oj, sj = jax.jit(lambda p, x, s: jr.recurrent_block(p, x, cj, s))(
        jp, jnp.asarray(x), None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()})
    ot, stt = tr.recurrent_block(tp, torch.from_numpy(x), ct,
                                 None if st is None else
                                 {k: torch.from_numpy(v)
                                  for k, v in st.items()})
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    np.testing.assert_array_equal(stt["conv"].numpy(),
                                  np.asarray(sj["conv"]))
    np.testing.assert_allclose(stt["lru"].numpy(), np.asarray(sj["lru"]),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_recurrent_block_step_matches_reference_and_writes_in_place():
    cj, ct, jp, tp = _rec_params()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    st = {"conv": rng.normal(size=(B, 3, 64)).astype(np.float32),
          "lru": rng.normal(size=(B, 64)).astype(np.float32)}
    oj, sj = jax.jit(lambda p, x, s: jr.recurrent_block_step(p, x, cj, s))(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    ot, out_state = tr.recurrent_block_step(tp, torch.from_numpy(x), ct,
                                            state)
    assert out_state is state
    assert {k: v.data_ptr() for k, v in state.items()} == ptrs
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)
    np.testing.assert_array_equal(state["conv"].numpy(),
                                  np.asarray(sj["conv"]))
    np.testing.assert_allclose(state["lru"].numpy(), np.asarray(sj["lru"]),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("fn", ["rg_lru_step", "causal_conv1d",
                                "recurrent_block_step"])
def test_bf16_promotion_matches_reference(fn):
    """bf16 parameters and activations, as at full width, against the
    reference run op by op: ``softplus(lam)`` in bf16, float32 ``u``
    against bf16 weights, the conv in bf16 (module docstring)."""
    cj, ct, jp, tp = _rec_params("bfloat16", seed=2)
    rng = np.random.default_rng(7)
    u = rng.normal(size=(B, 64)).astype(np.float32)
    h = rng.normal(size=(B, 64)).astype(np.float32)
    conv = jnp.asarray(rng.normal(size=(B, 3, 64)), jnp.bfloat16)
    if fn == "rg_lru_step":
        hj, _ = jr.rg_lru_step(jp, jnp.asarray(u), jnp.asarray(h))
        ht, _ = tr.rg_lru_step(tp, torch.from_numpy(u), torch.from_numpy(h))
        assert ht.dtype == torch.float32
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                                   atol=BF16_STATE_ATOL)
    elif fn == "causal_conv1d":
        x = jnp.asarray(rng.normal(size=(B, 7, 64)), jnp.bfloat16)
        for run in (jr.causal_conv1d, jax.jit(jr.causal_conv1d)):
            oj, sj = run(jp["conv_w"], x, conv)
            ot, st = tr.causal_conv1d(tp["conv_w"], _bf16(x), _bf16(conv))
            assert ot.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(ot), np.asarray(oj, np.float32))
            np.testing.assert_array_equal(_np(st), np.asarray(sj, np.float32))
    else:
        x = jnp.asarray(rng.normal(size=(B, 1, 64)), jnp.bfloat16)
        oj, sj = jr.recurrent_block_step(
            jp, x, cj, {"conv": conv, "lru": jnp.asarray(h)})
        state = {"conv": _bf16(conv), "lru": torch.from_numpy(h.copy())}
        ot, state = tr.recurrent_block_step(tp, _bf16(x), ct, state)
        np.testing.assert_array_equal(_np(state["conv"]),
                                      np.asarray(sj["conv"], np.float32))
        np.testing.assert_allclose(state["lru"].numpy(),
                                   np.asarray(sj["lru"]), rtol=0,
                                   atol=BF16_STATE_ATOL)
        out = np.asarray(oj, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(out).max())) - 7)
        np.testing.assert_allclose(_np(ot), out, rtol=0,
                                   atol=BF16_OUT_ULPS * ulp)


# =========================================================================
# local attention and the ring buffer
# =========================================================================
@pytest.mark.parametrize("t", [5, 8, 19])
def test_ring_from_segment_is_exact(t):
    """At t < W (slots past t hold zeros), t = W and t > W (the ring has
    wrapped)."""
    rng = np.random.default_rng(t)
    k = rng.normal(size=(B, t, 1, 16)).astype(np.float32)
    v = rng.normal(size=(B, t, 1, 16)).astype(np.float32)
    kj, vj = j_ring(jnp.asarray(k), jnp.asarray(v), 8)
    kt, vt = _ring_from_segment(torch.from_numpy(k), torch.from_numpy(v), 8)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("q_offset", [0, 5])
def test_windowed_mha_matches_reference(q_offset):
    """Local causal attention at ``tq > chunk_q`` (the reference pads the
    last chunk; the port's last chunk is ragged), one KV head."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(B, 40, 4, 16)).astype(np.float32)
    k = rng.normal(size=(B, 40, 1, 16)).astype(np.float32)
    v = rng.normal(size=(B, 40, 1, 16)).astype(np.float32)
    kw = dict(causal=True, window=8, q_offset=q_offset, chunk_q=16)
    oj = jattn.mha(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    ot = tattn.mha(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("pos", [3, 8, 21])
def test_ring_decode_attend_matches_reference(pos):
    rng = np.random.default_rng(pos)
    w = 8
    q = rng.normal(size=(B, 1, 4, 16)).astype(np.float32)
    kr = rng.normal(size=(B, w, 1, 16)).astype(np.float32)
    vr = rng.normal(size=(B, w, 1, 16)).astype(np.float32)
    slots = np.arange(w)
    stored = pos - ((pos - slots) % w)
    oj = jattn.ring_decode_attend(jnp.asarray(q), jnp.asarray(kr),
                                  jnp.asarray(vr), jnp.asarray(stored),
                                  jnp.asarray(pos), w)
    for p in (pos, torch.tensor(pos)):
        ot = tattn.ring_decode_attend(
            torch.from_numpy(q), torch.from_numpy(kr), torch.from_numpy(vr),
            torch.from_numpy(stored), p, w)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


# =========================================================================
# prefill and greedy decode against the reference
# =========================================================================
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


@functools.lru_cache(maxsize=None)
def _ref_greedy(sites, form):
    cj, _, pj, _, tokens, plans = _model(sites)
    if form == "exact":
        cfg, tables = cj, None
    else:
        cfg = plans.patched_config(cj)
        tables = plans.tables_for_model(
            backend="gather", mesh=False,
            plan_exec="unrolled" if form == "unrolled" else "stacked")
    return j_greedy(cfg, pj, {"tokens": jnp.asarray(tokens)}, T, NEW,
                    T + NEW, tables)


def _compare(ref, got, atol):
    (rt, rl), (gt, gl) = ref, got
    assert gt == rt
    for a, b in zip(rl, gl):
        np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_exact_decode_matches_reference():
    _, ct, _, pt, tokens, _ = _model()
    _compare(_ref_greedy("act", "exact"), _port_greedy(ct, pt, tokens, None),
             NOLUT_ATOL)


@pytest.mark.parametrize("sites, form", [
    ("act", "stacked"), ("act", "unrolled"), ("act", "fused"),
    ("all", "stacked"), ("all", "fused")])
def test_lut_decode_matches_reference(sites, form):
    """The reference's per-site plans (``mlp``; with ``sites="all"`` also
    ``norm_rsqrt``, the hybrid's other site) on the port's gather backend:
    stacked and unrolled tables, and the fused super-slab (``mlp`` through
    the plain K3, ``norm_rsqrt`` through the plain K4), against the
    reference's gather decode on the same plans."""
    _, ct, _, pt, tokens, plans = _model(sites)
    want = ["mlp", "norm_rsqrt"] if sites == "all" else ["mlp"]
    assert sorted(plans.sites) == want
    ct_l = dataclasses.replace(ct, lut_activation=True)
    if form == "fused":
        tj = plans.tables_for_model(backend="pallas", kernel="fused",
                                    mesh=False)
        tt = dict(tables_from_jax(to_np(tj), device="cpu"),
                  backend="gather")
        assert all(tt["sites"][s] == {"multi": s} for s in want)
        ct_l = dataclasses.replace(ct_l, lut_fuse=True)
        ref = _ref_greedy(sites, "stacked")
    else:
        tj = plans.tables_for_model(backend="gather", mesh=False,
                                    plan_exec=form)
        tt = tables_from_jax(to_np(tj), device="cpu")
        ref = _ref_greedy(sites, form)
    _compare(ref, _port_greedy(ct_l, pt, tokens, tt), LUT_ATOL)


def test_decode_through_the_wrapped_ring_matches_the_full_forward():
    """The reference's ``test_hybrid_decode_matches_forward`` scenario on
    the port alone, in float32: prefill T = 24 > window 8 and decode 3
    tokens through the ring; every step's logits equal the full forward's
    at its position, within ``NOLUT_ATOL``; the reference's own forward
    agrees too."""
    cj, ct, pj, pt, _, _ = _model()
    rng = np.random.default_rng(3)
    full = torch.as_tensor(rng.integers(1, ct.vocab_size, (B, T + 3)))
    logits, cache = prefill(pt, ct, {"tokens": full[:, :T]})
    outs = [logits]
    for i in range(2):
        lg, cache = decode_step(pt, ct, cache, full[:, T + i:T + i + 1],
                                T + i)
        outs.append(lg)
    dec = torch.cat(outs, dim=1).numpy()
    x, _ = hybrid_forward(pt, ct, full)
    ref = project_logits(x, pt.lm_head, ct)[:, T - 1:T + 2].numpy()
    np.testing.assert_allclose(dec, ref, rtol=0, atol=NOLUT_ATOL)
    xj, _ = j_hybrid_forward(pj, cj, jnp.asarray(full.numpy(), jnp.int32))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=NOLUT_ATOL)


# =========================================================================
# calibration and the mlp slabs
# =========================================================================
def test_capture_matches_reference():
    """``L{i}/mlp`` for the 4 layers (groups and tail): the reference's
    keys, sample counts and histograms."""
    cj, ct, pj, pt, *_ = _model()
    cap_j = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2,
                                              seq_len=16, seed=1))
    cap_t = t_capture_model(pt, ct, t_batches(ct, 2, batch_size=2,
                                              seq_len=16, seed=1))
    want = sorted(f"L{l}/mlp" for l in range(ct.n_layers))
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == want
    assert (cap_t.n_samples, cap_t.n_batches) == (cap_j.n_samples,
                                                  cap_j.n_batches)
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        assert ht.sum() == hj.sum(), key
        moved = np.abs(ht - hj).sum() / 2
        assert moved <= HIST_MOVE_FRAC * hj.sum(), (key, moved)
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
    """The port's plans from the reference's calibration serve ``mlp``
    with the reference's slabs: equal payload checksums and bytes, raw and
    bit-packed, and in the fused super-slab."""
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
# a step that reads nothing back to the host
# =========================================================================
def _smoke_tables(sites="all"):
    cfg = dataclasses.replace(tconfigs.smoke_config(
        tconfigs.get_config(ARCH)), lut_sites=sites)
    params = init_params(cfg, seed=3, device="cpu")
    calib = np.random.default_rng(0).normal(size=20000) * 3
    tables = build_serving_plans(cfg, calib).tables_for_model(device="cpu")
    return dataclasses.replace(cfg, lut_activation=True), params, tables


def test_tensor_pos_gives_int_pos_bits():
    """``pos`` as a 0-d tensor (what a captured step reads) gives the bits
    of ``pos`` as a Python int: logits and every state tensor, on the
    bf16 smoke config at positions before and after the ring wraps."""
    cfg, params, tables = _smoke_tables()
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 12)))
    for t in (5, 11):
        _, cache = prefill(params, cfg, {"tokens": toks[:, :t]},
                           lut_tables=tables)
        outs = []
        for p in (t, torch.tensor(t)):
            c = clone_state(cache)
            lg, c = decode_step(params, cfg, c, toks[:, t:t + 1], p, tables)
            outs.append((lg, dict(state_leaves(c))))
        (li, ci), (lt, ct_) = outs
        assert torch.equal(li, lt)
        for name in ci:
            assert torch.equal(ci[name], ct_[name]), name


def _refuse(name):
    def refused(*a, **kw):
        raise AssertionError(f"{name} on the decode step")
    return refused


def test_decode_step_has_no_host_sync(monkeypatch):
    """A hybrid decode step with every site in scope (tables stacked, so
    the layer ids index them) calls nothing that reads a tensor back to
    the host (``item``, ``tolist``, truth values, ``nonzero``): the ring
    slot, the stored positions and the mask come from the 0-d ``pos`` on
    the device, and every state tensor is written in place."""
    cfg, params, tables = _smoke_tables()
    cache = init_cache(cfg, 2, 1, device="cpu")
    ptrs = {n: t.data_ptr() for n, t in state_leaves(cache)}
    before = clone_state(cache)
    tok = torch.tensor([[5], [7]])
    for owner, names in ((torch.Tensor, ("item", "tolist", "__bool__",
                                         "nonzero")),
                         (torch, ("nonzero",))):
        for name in names:
            monkeypatch.setattr(owner, name, _refuse(name))
    lg, out = decode_step(params, cfg, cache, tok, torch.tensor(9), tables)
    monkeypatch.undo()
    assert lg.shape == (2, 1, cfg.vocab_size) and out is cache
    assert {n: t.data_ptr() for n, t in state_leaves(cache)} == ptrs
    changed = {n for n, t in state_leaves(cache)
               if not torch.equal(t, dict(state_leaves(before))[n])}
    # every layer's state moved: the conv windows, the LRU vectors and the
    # ring's slot 9 % 8
    assert changed == set(ptrs)


# =========================================================================
# the launcher
# =========================================================================
@pytest.mark.parametrize("extra", [[], ["--lut-sites", "all", "--lut-fuse"]])
def test_launcher_serves_hybrid_on_cpu(extra, capsys):
    """``--arch recurrentgemma-9b`` on the gather backend; ``--kv-int8``
    does nothing for the hybrid family, as in the reference."""
    argv = ["--device", "cpu", "--arch", ARCH, "--batch", "2",
            "--prompt-len", "11", "--new-tokens", "3", "--lut-act",
            "--calib-steps", "1", "--lut-backend", "gather", "--kv-int8"]
    out = launcher.main(argv + extra)
    printed = capsys.readouterr().out
    assert f"{ARCH}-smoke: parameters: " in printed
    assert "int8" not in printed and out["replay_s"] is None
    assert len(out["tokens"]) == 2 and len(out["tokens"][0]) == 3
