"""The port's continuous batcher, prefill replay and int8 KV cache against
the JAX reference, on the float32 smoke config of qwen3-0.6b (2 layers,
d_model 64) with the reference's parameters carried across by
``bridge.params_from_jax`` (and, for the LUT case, the reference's own
serving tables by ``bridge.tables_from_jax``).  Both sides serve on the
CPU, where the port's step runs eagerly; the reference's steps are
jitted, as its batcher runs them.

The batcher cases are the reference's ``tests/test_batching.py`` (11),
its replay cases of ``tests/test_calib.py`` (3) and the int8 cases of
``tests/test_serve_features.py`` (2, on qwen3-0.6b: the port serves no
nemotron), each also held against the reference's batcher where it
serves tokens.

Tolerances: the batchers' caches are bf16 (int8 with ``kv_dtype="int8"``)
whatever the model's dtype, as the reference's ``cache_specs``; greedy
tokens must be identical request by request.  float32 logits of the two
frameworks agree to about 1e-6 relative (other summation orders), so a
decode step's logits are held within ``ATOL`` = 2e-5.  The quantizer
(``_quantize_kv``) gives the reference's bits, int8 entries and float32
scales, on the same inputs.  The int8 cache after a whole replay: its
``k`` / ``v`` entries equal the reference's exactly, but its scales are
held within ``SCALE_RTOL`` = 1e-6 relative, not to 1 ulp: a scale is
``max |k| / 127 + 1e-8`` of the step's own ``k``, which the two
frameworks compute with matmuls summed in other orders, a few ulps apart
(up to 5 ulps of float32 here, 6e-7 relative); a quantized entry would
move only where an input lands that close to a rounding edge, and none
does.  A step at ``pos`` given as a 0-d tensor gives the same bits as at
``pos`` given as an int, in both families.
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
from repro.serve import decode_step as j_decode_step
from repro.serve import prefill_replay as j_prefill_replay
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro.serve.kvcache import cache_specs as j_cache_specs
from repro.serve.kvcache import init_cache as j_init_cache
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.nn import init_params
from repro_torch.serve import (
    CapturedStep,
    ContinuousBatcher,
    Request,
    decode_fn,
    decode_step,
    init_cache,
    prefill,
    prefill_replay,
)

ATOL = 2e-5
SCALE_RTOL = 1e-6


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


@pytest.fixture(scope="module")
def model():
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    return cj, ct, pj, pt


def _greedy_reference(cfg, params, prompt, max_new, max_seq):
    """Single-request decode-only greedy tokens through the port's step,
    on the batcher's bf16 cache."""
    cache = init_cache(cfg, 1, max_seq, device="cpu")
    out = []
    for pos in range(len(prompt) + max_new - 1):
        t = prompt[pos] if pos < len(prompt) else out[-1]
        logits, cache = decode_step(params, cfg, cache,
                                    torch.tensor([[int(t)]]), pos)
        nxt = int(torch.argmax(logits[0, -1]))
        if pos >= len(prompt) - 1:
            out.append(nxt)
            if len(out) >= max_new:
                break
    return out


def _serve_both(model, prompts, max_new, *, batch_size=2, max_seq=32,
                lut=None, **kw):
    """The same requests through the reference's batcher and the port's:
    ``(reference outs, port outs, port batcher)``, by request id.
    ``max_new``: one for every request, or a list of one each."""
    cj, ct, pj, pt = model
    if isinstance(max_new, int):
        max_new = [max_new] * len(prompts)
    outs = []
    for cls, req, cfg, params, tables in (
            (JBatcher, JRequest, cj, pj, None if lut is None else lut[0]),
            (ContinuousBatcher, Request, ct, pt,
             None if lut is None else lut[1])):
        b = cls(cfg if lut is None else lut[2 if cls is JBatcher else 3],
                params, batch_size=batch_size, max_seq=max_seq,
                lut_tables=tables, **kw)
        for i, (p, n) in enumerate(zip(prompts, max_new)):
            b.submit(req(rid=i, prompt=list(p), max_new=n))
        outs.append([r.out for r in sorted(b.run(), key=lambda r: r.rid)])
    return outs[0], outs[1], b


# =========================================================================
# the reference's tests/test_batching.py
# =========================================================================
def test_batcher_completes_all_requests(model):
    cfg = model[1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 4 + 3 * i) for i in range(5)]
    ref, got, b = _serve_both(model, prompts, 4, batch_size=3, max_seq=48,
                              eos_token=-1)
    assert len(got) == 5 and all(len(o) == 4 for o in got)
    assert 0 < b.utilization <= 1.0
    assert got == ref


def test_slot_fills_to_max_seq(model):
    """A slot decodes until its position reaches max_seq (the last cache
    row is usable) and is evicted exactly there."""
    cfg = model[1]
    rng = np.random.default_rng(2)
    max_seq = 8
    prompt = rng.integers(1, cfg.vocab_size, 5)
    ref, got, b = _serve_both(model, [prompt], 100, batch_size=1,
                              max_seq=max_seq, eos_token=-1)
    assert b.finished[0].done
    assert len(got[0]) == max_seq - len(prompt) + 1
    assert all(s.req is None for s in b.slots)
    assert got == ref


def test_prompt_longer_than_cache_truncates(model):
    """A prompt that alone overflows the cache is truncated and evicted;
    its neighbour is unaffected."""
    _, cfg, _, params = model
    rng = np.random.default_rng(3)
    max_seq = 8
    long_prompt = rng.integers(1, cfg.vocab_size, max_seq + 4)
    short_prompt = rng.integers(1, cfg.vocab_size, 3)
    want = _greedy_reference(cfg, params, short_prompt, 3, max_seq)
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=max_seq,
                          eos_token=-1)
    b.submit(Request(rid=0, prompt=list(long_prompt), max_new=4))
    b.submit(Request(rid=1, prompt=list(short_prompt), max_new=3))
    done = sorted(b.run(), key=lambda r: r.rid)
    assert len(done) == 2 and done[0].done
    assert done[1].out == want
    ref, got, _ = _serve_both(model, [long_prompt, short_prompt], 3,
                              max_seq=max_seq, eos_token=-1)
    assert got == ref


def test_eos_eviction_and_slot_refill(model):
    """EOS evicts a request early and the freed slot picks up queued
    work."""
    _, cfg, _, params = model
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, cfg.vocab_size, 4)
    eos = _greedy_reference(cfg, params, prompt, 1, 32)[0]
    other = rng.integers(1, cfg.vocab_size, 3)
    ref, got, _ = _serve_both(model, [prompt, other], [10, 2], batch_size=1,
                              max_seq=32, eos_token=eos)
    assert len(got) == 2        # the single slot was refilled
    assert got[0] == [eos]      # stopped at EOS, not at max_new
    assert len(got[1]) == 2
    assert got == ref


def test_utilization_accounting(model):
    """utilization == active-slot work / (ticks * slots), exactly."""
    _, cfg, _, params = model
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(1, cfg.vocab_size, 4)) for _ in range(2)]
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=16,
                          eos_token=-1)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=p, max_new=3))
    b.run()
    assert b.utilization == 1.0
    assert b.active_slot_steps == b.steps * 2
    b2 = ContinuousBatcher(cfg, params, batch_size=2, max_seq=16,
                           eos_token=-1)
    b2.submit(Request(rid=0, prompt=prompts[0], max_new=3))
    b2.run()
    assert b2.utilization == 0.5
    assert b2.active_slot_steps == b2.steps


def test_batcher_matches_single_request_decode(model):
    """Staggered multi-request batching changes no request's greedy
    output (cache isolation across slots and positions)."""
    _, cfg, _, params = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (3, 6, 5)]
    want = [_greedy_reference(cfg, params, p, 3, 32) for p in prompts]
    ref, got, _ = _serve_both(model, prompts, 3, eos_token=-1)
    assert got == want == ref


def test_empty_prompt_rejected_at_submit(model):
    _, cfg, _, params = model
    b = ContinuousBatcher(cfg, params, batch_size=1, max_seq=8,
                          eos_token=-1)
    with pytest.raises(ValueError, match="request 7: empty prompt"):
        b.submit(Request(rid=7, prompt=[], max_new=2))
    assert b.submitted == 0 and not b.queue


def test_stall_detection_names_stuck_request(model):
    """A request that can never be admitted (zero-slot pool) raises naming
    its rid instead of spinning to max_ticks."""
    _, cfg, _, params = model
    b = ContinuousBatcher(cfg, params, batch_size=0, max_seq=8,
                          eos_token=-1)
    b.submit(Request(rid=42, prompt=[1, 2], max_new=2))
    with pytest.raises(RuntimeError, match=r"stalled.*\[42\]"):
        b.run(stall_ticks=3)


def test_metrics_accounting_and_slo(model):
    _, cfg, _, params = model
    rng = np.random.default_rng(3)
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=16,
                          eos_token=-1)
    for i in range(3):
        b.submit(Request(rid=i, prompt=list(rng.integers(1, cfg.vocab_size,
                                                         4)),
                         max_new=3, slo_ms=0.001 if i == 0 else 1e9))
    b.run()
    m = b.metrics()
    assert m["submitted"] == m["finished"] == 3
    assert m["dropped"] == 0 and m["queued"] == 0 and m["active"] == 0
    assert m["latency_p50_s"] > 0 and m["latency_max_s"] >= m["latency_p50_s"]
    assert m["ttft_p50_s"] is not None
    assert m["slo_tracked"] == 3 and m["slo_violations"] == 1
    assert m["table_swaps"] == 0


def test_metrics_zero_finished_requests(model):
    """metrics() with nothing finished returns well-defined numbers."""
    _, cfg, _, params = model
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=8,
                          eos_token=-1)
    m = b.metrics()
    assert m["submitted"] == m["finished"] == m["dropped"] == 0
    for key in ("latency_p50_s", "latency_p95_s", "latency_max_s",
                "ttft_p50_s", "utilization"):
        assert isinstance(m[key], float) and m[key] == m[key], key
        f"{m[key]:.3f}"
    assert m["latency_p50_s"] == 0.0 and m["latency_max_s"] == 0.0
    assert m["slo_tracked"] == 0 and m["slo_violations"] == 0


def test_metrics_single_request_percentiles(model):
    """One finished request: every percentile is its latency."""
    _, cfg, _, params = model
    rng = np.random.default_rng(6)
    b = ContinuousBatcher(cfg, params, batch_size=1, max_seq=16,
                          eos_token=-1)
    b.submit(Request(rid=0, prompt=list(rng.integers(1, cfg.vocab_size, 4)),
                     max_new=2))
    b.run()
    m = b.metrics()
    assert m["finished"] == 1
    assert m["latency_p50_s"] > 0.0
    assert m["latency_p50_s"] == m["latency_p95_s"] == m["latency_max_s"]
    assert m["ttft_p50_s"] > 0.0


# =========================================================================
# the reference's replay cases (tests/test_calib.py)
# =========================================================================
def _run_batcher(cfg, params, prompts, max_new, **kw):
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=16,
                          eos_token=-1, **kw)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=list(p), max_new=max_new))
    return sorted(b.run(), key=lambda r: r.rid)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_batcher_replay_matches_step(model, kv_dtype):
    """Prefill replay serves token for token what per-tick ingestion
    serves, through the int8 write path too."""
    _, cfg, _, params = model
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (4, 6, 3)]
    step = _run_batcher(cfg, params, prompts, 3, kv_dtype=kv_dtype)
    replay = _run_batcher(cfg, params, prompts, 3, kv_dtype=kv_dtype,
                          prefill="replay")
    for a, b in zip(step, replay):
        assert a.out == b.out, (a.rid, a.out, b.out)


@pytest.fixture(scope="module")
def lut(model):
    """The reference's per-site plans (w_in 8, w_out 8) as both packages'
    tables and patched configs."""
    cj, ct, pj, _ = model
    calib = j_capture(pj, cj, j_batches(cj, 2, batch_size=2, seq_len=8,
                                        seed=1), w_in=8)
    plans = j_build(cj, calib, w_out=8)
    tj = plans.tables_for_model(backend="gather", mesh=False)
    return (tj, tables_from_jax(to_np(tj), device="cpu"),
            plans.patched_config(cj),
            dataclasses.replace(ct, lut_activation=True))


@pytest.mark.parametrize("prefill_mode", ["step", "replay"])
def test_batcher_replay_with_lut_tables(model, lut, prefill_mode):
    """Replay evaluates the same per-site LUT activations as decode: both
    modes serve the step mode's tokens, and the reference's."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 256, n) for n in (4, 5)]
    pt = model[3]
    step = _run_batcher(lut[3], pt, prompts, 3, lut_tables=lut[1])
    ref, got, _ = _serve_both(model, prompts, 3, max_seq=16, eos_token=-1,
                              lut=lut, prefill=prefill_mode)
    assert got == ref == [r.out for r in step]


def test_batcher_replay_truncates_overlong_prompt(model):
    _, cfg, _, params = model
    rng = np.random.default_rng(9)
    long_prompt = rng.integers(1, cfg.vocab_size, 20)   # > max_seq
    done = _run_batcher(cfg, params, [long_prompt], 4, prefill="replay")
    assert done[0].done and done[0].out == []
    assert len(done) == 1


# =========================================================================
# the reference's int8 cases (tests/test_serve_features.py), on qwen3
# =========================================================================
def test_int8_kv_cache_matches_bf16_decode(model):
    """Quantized-KV decode logits track the bf16-cache logits (argmax
    agreement), and equal the reference's int8 decode within ATOL."""
    cj, ct, pj, pt = model
    b, t, n = 2, 24, 6
    toks = np.random.default_rng(0).integers(1, ct.vocab_size, (b, t + n))
    tt = torch.as_tensor(toks)
    logits, cache = prefill(pt, ct, {"tokens": tt[:, :t]}, max_seq=t + n)
    lg_bf16 = []
    for i in range(n):
        lg, cache = decode_step(pt, ct, cache, tt[:, t + i:t + i + 1],
                                t + i)
        lg_bf16.append(lg[:, -1])
    cache = init_cache(ct, b, t + n, device="cpu", kv_dtype="int8")
    jcache = j_init_cache(cj, b, t + n, kv_dtype="int8")
    jstep = jax.jit(lambda p, c, tk, pos: j_decode_step(p, cj, c, tk, pos))
    lg_int8 = []
    for i in range(t + n):
        lg, cache = decode_step(pt, ct, cache, tt[:, i:i + 1], i)
        jlg, jcache = jstep(pj, jcache, jnp.asarray(toks[:, i:i + 1],
                                                    jnp.int32),
                            jnp.asarray(i))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=ATOL)
        if i >= t:
            lg_int8.append(lg[:, -1])
    a = torch.stack(lg_bf16).argmax(-1)
    q = torch.stack(lg_int8).argmax(-1)
    assert float((a == q).float().mean()) > 0.9


def test_int8_cache_shapes_and_footprint():
    cfg = tconfigs.get_config("qwen3-0.6b")
    cache = init_cache(cfg, 4, 128, device="cpu", kv_dtype="int8")
    spec = j_cache_specs(jconfigs.get_config("qwen3-0.6b"), 4, 128,
                         kv_dtype="int8")
    for name, s in spec.items():
        assert tuple(cache[name].shape) == s.shape, name
        assert str(cache[name].dtype).split(".")[-1] == s.dtype.name, name
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (cfg.n_layers, 4, 128, cfg.n_kv_heads)
    bf16 = init_cache(cfg, 4, 128, device="cpu")
    nbytes = lambda c: sum(v.numel() * v.element_size() for v in c.values())
    assert nbytes(cache) < 0.6 * nbytes(bf16)
    with pytest.raises(ValueError, match="kv_dtype"):
        init_cache(cfg, 1, 8, device="cpu", kv_dtype="fp8")


# =========================================================================
# the port against the reference batcher, replay and cache bit for bit
# =========================================================================
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("prefill_mode", ["step", "replay"])
def test_staggered_requests_match_reference(model, prefill_mode, kv_dtype):
    """Requests of several lengths, more than the slots, through both
    batchers: identical ``out`` lists per request."""
    cfg = model[1]
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (5, 2, 9, 4, 7)]
    ref, got, b = _serve_both(model, prompts, 5, batch_size=3, max_seq=24,
                              eos_token=-1, prefill=prefill_mode,
                              kv_dtype=kv_dtype)
    assert got == ref
    assert b.metrics()["dropped"] == 0
    if prefill_mode == "replay":
        assert b.replayed_tokens == sum(len(p) for p in prompts)


def test_int8_cache_after_prefill_replay_matches_reference(model):
    """After replaying the same prompts into an int8 cache, the port's
    int8 entries equal the reference's and its scales agree within 1 ulp
    (see the module docstring)."""
    cj, ct, pj, pt = model
    b, t = 3, 12
    toks = np.random.default_rng(12).integers(1, ct.vocab_size, (b, t))
    cache = init_cache(ct, b, t + 4, device="cpu", kv_dtype="int8")
    lg, cache = prefill_replay(pt, ct, cache, torch.as_tensor(toks))
    jlg, jcache = jax.jit(lambda p, c, tk: j_prefill_replay(
        p, cj, c, tk, 0))(pj, j_init_cache(cj, b, t + 4, kv_dtype="int8"),
                          jnp.asarray(toks, jnp.int32))
    assert tuple(lg.shape) == tuple(jlg.shape) == (b, 1, ct.vocab_size)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                               atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_array_equal(cache[name].numpy(),
                                      np.asarray(jcache[name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bits_equal_reference(dtype):
    """On the same inputs the port's quantizer gives the reference's int8
    entries and scales bit for bit, values a hair from rounding edges and
    at the clip included."""
    from repro.nn.transformer import _quantize_kv as j_quantize
    from repro_torch.nn.transformer import _quantize_kv

    rng = np.random.default_rng(16)
    x = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    # entries at k + 1/2 steps of their row's scale (less 1e-8 / 0.25)
    x[0, 0, 0, :8] = (np.arange(8) + 0.5) * np.float32(0.25)
    x[0, 0, 0, 8] = 127 * np.float32(0.25)
    xj = jnp.asarray(x, dtype=dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    qj, sj = j_quantize(xj)
    qt, st = _quantize_kv(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.dtype == torch.float32
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()


def _pos_bits(params, cfg, cache, tokens, pos):
    """Logits and cache of one step at ``pos`` as an int and as a 0-d
    tensor, on copies of ``cache``."""
    outs = []
    for p in (pos, torch.tensor(pos)):
        c = {k: v.clone() for k, v in cache.items()}
        lg, c = decode_step(params, cfg, c, tokens, p)
        outs.append((lg, c))
    return outs


@pytest.mark.parametrize("form", ["dense", "dense int8", "ssm"])
def test_decode_step_tensor_pos_gives_int_pos_bits(form):
    """``pos`` as a 0-d tensor (what a captured step reads) gives the bits
    of ``pos`` as a Python int, logits and cache, in both families."""
    arch = "rwkv6-3b" if form == "ssm" else "qwen3-0.6b"
    cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    params = init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(13)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 6)))
    if form == "dense int8":
        cache = init_cache(cfg, 2, 8, device="cpu", kv_dtype="int8")
        _, cache = prefill_replay(params, cfg, cache, toks[:, :5])
    else:
        _, cache = prefill(params, cfg, {"tokens": toks[:, :5]}, max_seq=8)
    (li, ci), (lt, ct_) = _pos_bits(params, cfg, cache, toks[:, 5:], 5)
    assert torch.equal(li, lt)
    for name in ci:
        assert torch.equal(ci[name], ct_[name]), name


def test_prefill_replay_equals_stepping(model):
    """``prefill_replay`` is T decode steps: the same logits and cache."""
    _, ct, _, pt = model
    toks = torch.as_tensor(np.random.default_rng(14).integers(
        1, ct.vocab_size, (2, 7)))
    c1 = init_cache(ct, 2, 10, device="cpu", kv_dtype="int8")
    c2 = {k: v.clone() for k, v in c1.items()}
    lg, c1 = prefill_replay(pt, ct, c1, toks, 2)
    for i in range(7):
        lg2, c2 = decode_step(pt, ct, c2, toks[:, i:i + 1], 2 + i)
    assert torch.equal(lg, lg2)
    for name in c1:
        assert torch.equal(c1[name], c2[name]), name
    with pytest.raises(ValueError, match="no tokens"):
        prefill_replay(pt, ct, c1, toks[:, :0])


def test_captured_step_is_for_the_card(model):
    """On the CPU the serving loops step eagerly; a captured step asked to
    run there raises instead of falling back."""
    _, ct, _, pt = model
    step = decode_fn(pt, ct)
    assert not isinstance(step, CapturedStep)
    cache = init_cache(ct, 1, 4, device="cpu")
    lg, _ = step(cache, torch.tensor([[3]]), 0)
    assert lg.shape == (1, 1, ct.vocab_size)
    with pytest.raises(ValueError, match="card"):
        CapturedStep(pt, ct)(cache, torch.tensor([[3]]), 0)


def test_batcher_swap_tables_and_mesh(model, lut):
    """``swap_tables`` rebuilds the step between ticks and serves on, and
    on a mesh (one rank here: the sharded steps, rebuilt by the swap; more
    ranks in tests/test_torch_sharded.py) the same outputs come out."""
    from repro_torch.launch.mesh import make_host_mesh

    _, ct, _, pt = model
    outs = {}
    for mesh in (None, make_host_mesh(1, 1, device="cpu")):
        rng = np.random.default_rng(15)
        b = ContinuousBatcher(ct, pt, batch_size=2, max_seq=16, eos_token=-1,
                              mesh=mesh)
        for i in range(3):
            b.submit(Request(rid=i, prompt=list(rng.integers(1, 256, 4)),
                             max_new=3))
        b.step()
        b.swap_tables(lut[1], cfg=lut[3])
        done = b.run()
        assert len(done) == 3 and b.metrics()["table_swaps"] == 1
        assert b.metrics()["dropped"] == 0
        outs[mesh is None] = {r.rid: r.out for r in done}
    assert outs[True] == outs[False]


@pytest.mark.parametrize("arch, family, why", [
    ("rwkv6-3b", "ssm", "recurrent state twice"),
    ("recurrentgemma-9b", "hybrid", "rings, conv windows"),
    ("phi-3-vision-4.2b", "vlm", "no patches"),
    ("whisper-small", "encdec", "zero cross K/V")])
def test_batcher_refuses_the_families_it_does_not_serve(arch, family, why):
    """The batcher serves dense and moe; on the other families the
    reference's batcher answers wrongly, so the port's refuses them, naming
    the reason (and builds no cache or step first)."""
    cfg = tconfigs.smoke_config(tconfigs.get_config(arch))
    assert cfg.family == family
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=why) as info:
        ContinuousBatcher(cfg, params, batch_size=2, max_seq=16)
    assert f"not {family!r}" in str(info.value)
