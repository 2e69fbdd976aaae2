"""The train step's memory plan for moe expert stacks, in process on the
CPU: AdamW in slices of a leaf's leading axis (``optim/adamw.py``), the
expert stacks' per-(layer, expert) norm terms, and int8 compression of a
share against its whole leaf's scale.  The sharded step that uses them on
gloo ranks is in ``tests/test_torch_train_sharded.py``.

Tolerances: AdamW in slices, a share's slab terms and a share's
compression are bit for bit (elementwise work, and the same reduction on
a slab of the same shape); the slab terms within ``1e-6`` relative of a
float64 recount (float32 sums of squares of at most a few thousand
entries); the single-device step's norm likewise, and for the families
without expert stacks bit for bit the norm the step took before the
expert terms existed (``global_norm`` of the gradients).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_apply,
    adamw_init,
    adamw_step_scalars,
    global_norm,
    slab_square_sums,
)
from repro_torch.train.compression import ef_compress_grads

NORM_RTOL = 1e-6

# leaves around a threshold of 64 elements: below it, rows of 35 and 9
# elements in slices of 1 and 7 rows, and rows of 100 one a slice
SHAPES = ((17,), (3, 5, 7), (40, 9), (2, 100))
SMALL_CHUNK = 64


def _whole_list_adamw(grads, state, params, cfg, clip, c1, c2, lr):
    """The update as it was before slices: the clip scale applied to a
    copy of every gradient, then each leaf whole."""
    gnorm = global_norm(grads)
    if clip is not None:
        scale = torch.minimum(torch.ones_like(gnorm), clip / (gnorm + 1e-9))
        grads = [g * scale for g in grads]
    div = torch.mul if torch.is_tensor(c1) else torch.div
    b1, b2 = cfg.b1, cfg.b2
    for p, g, m, v in zip(params, grads, state["mu"], state["nu"]):
        m.copy_(b1 * m + (1 - b1) * g.to(m.dtype))
        v.copy_(b2 * v + (1 - b2) * torch.square(g.to(v.dtype)))
        step = div(m, c1) / (torch.sqrt(div(v, c2)) + cfg.eps)
        if cfg.weight_decay > 0:
            step = step + cfg.weight_decay * p.to(step.dtype)
        p.copy_((p.float() - lr * step).to(p.dtype))
    return gnorm


def _leaves(dtype, grad_scale, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, k=1.0: torch.from_numpy(
        (rng.normal(size=s) * k).astype(np.float32)).to(dtype)
    params = [mk(s) for s in SHAPES]
    grads = [mk(s, grad_scale) for s in SHAPES]
    state = adamw_init(params)
    state["mu"] = [mk(s, 0.1) for s in SHAPES]
    state["nu"] = [mk(s, 0.01).abs() for s in SHAPES]
    return params, grads, state


@pytest.mark.parametrize("form", ["floats", "scalars"])
@pytest.mark.parametrize("clip", [None, 1.0, 1e6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_chunks_is_adamw_whole(monkeypatch, dtype, clip, form):
    """Leaves above and below a threshold of ``SMALL_CHUNK`` elements,
    updated in slices, bit for bit the whole-list update (parameters,
    moments, the returned norm); ``clip`` 1.0 binds (the norm is about
    50), 1e6 does not, None clips nothing; the step's values as Python
    floats and as the captured form's 0-d tensors."""
    cfg = AdamWConfig(lr=1e-3, grad_clip_norm=clip)
    count = 3
    if form == "floats":
        c1 = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(count))
        lr = float(cfg.lr_at(count))
    else:
        c1, c2, lr = torch.as_tensor(adamw_step_scalars(cfg, count))
    clip_t = None if clip is None else torch.tensor(np.float32(clip))
    p0, g0, s0 = _leaves(dtype, 2.0)
    p1, g1, s1 = _leaves(dtype, 2.0)
    monkeypatch.setattr(adamw_mod, "ADAMW_CHUNK", SMALL_CHUNK)
    got = adamw_apply(g0, s0, p0, cfg, clip_t, c1, c2, lr)
    want = _whole_list_adamw(g1, s1, p1, cfg, clip_t, c1, c2, lr)
    assert torch.equal(got, want)
    for a, b in zip(p0 + s0["mu"] + s0["nu"], p1 + s1["mu"] + s1["nu"]):
        assert a.dtype == dtype and torch.equal(a, b)
    # the leaves really were cut
    assert [len(adamw_mod._chunks(p)) for p in p0] == [1, 3, 6, 2]


def test_chunks_take_a_layer_of_an_expert_stack():
    """At the default threshold: deepseek-moe-16b's ``moe_w_in`` share on
    1x4 (28 layers of 92 M elements) one layer a slice, its embedding's
    share (25600 x 2048) in slices of 8192 rows, a norm vector whole;
    every slice a view of the leaf."""
    stack = torch.empty((28, 16, 2048, 2816), device="meta",
                        dtype=torch.bfloat16)
    parts = adamw_mod._chunks(stack)
    assert len(parts) == 28
    assert all(p.shape == (1, *stack.shape[1:]) for p in parts)
    embed = torch.empty((25600, 2048), device="meta")
    assert [p.shape[0] for p in adamw_mod._chunks(embed)] == [8192] * 3 + [
        1024]
    norm = torch.empty((28, 2048))
    (whole,) = adamw_mod._chunks(norm)
    assert whole is norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slab_square_sums_against_a_float64_recount(dtype):
    """Each ``(layer, expert)`` slab's float32 square sum, and their sum,
    within ``NORM_RTOL`` of float64."""
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.normal(size=(3, 4, 24, 40)).astype(
        np.float32)).to(dtype)
    sq = slab_square_sums(t)
    assert sq.shape == (3, 4) and sq.dtype == torch.float32
    ref = (t.double() ** 2).sum(dim=(2, 3))
    np.testing.assert_allclose(sq.double().numpy(), ref.numpy(),
                               rtol=NORM_RTOL)
    total = float(torch.sum(sq))
    assert abs(total - float(ref.sum())) <= NORM_RTOL * float(ref.sum())


@pytest.mark.parametrize("tp", [2, 4])
def test_a_shares_slab_terms_are_the_whole_stacks_bits(tp):
    """A share over the expert axis gives its experts' terms bit for bit
    the whole stack's, so the terms gathered in expert order are the
    whole stack's tensor and sum to the same bits."""
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.normal(size=(2, 8, 16, 12)).astype(np.float32))
    whole = slab_square_sums(t)
    e = t.shape[1] // tp
    parts = [slab_square_sums(t[:, k * e:(k + 1) * e].contiguous())
             for k in range(tp)]
    for k, part in enumerate(parts):
        assert torch.equal(part, whole[:, k * e:(k + 1) * e])
    assert torch.equal(torch.sum(torch.cat(parts, dim=1)), torch.sum(whole))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compressing_a_share_is_the_whole_leafs_slice(dtype):
    """``ef_compress_grads`` on a share with the whole leaf's ``max|x|``:
    codes, scale and new error bit for bit the slice of the whole leaf's
    compression."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(2, 8, 6, 5)).astype(
        np.float32)).to(dtype)
    err = torch.from_numpy(rng.normal(size=g.shape).astype(np.float32)
                           * 1e-2)
    (q, ), (s, ), (ne, ) = ef_compress_grads([g], [err])
    amax = torch.amax(torch.abs(g.float() + err))
    for k in range(4):
        cut = slice(2 * k, 2 * k + 2)
        (qk, ), (sk, ), (nek, ) = ef_compress_grads(
            [g[:, cut].contiguous()], [err[:, cut].contiguous()],
            lambda share_max: torch.maximum(share_max, amax))
        assert torch.equal(sk, s)
        assert torch.equal(qk, q[:, cut]) and torch.equal(nek, ne[:, cut])


def _step_spy(monkeypatch):
    """Record what the train step hands ``adamw_update``: ``[(grads,
    gnorm)]``."""
    from repro_torch.train import step as step_mod

    seen = []
    orig = step_mod.adamw_update

    def spy(grads, *a, gnorm=None, **kw):
        seen.append(([g.clone() for g in grads], gnorm.clone()))
        return orig(grads, *a, gnorm=gnorm, **kw)

    monkeypatch.setattr(step_mod, "adamw_update", spy)
    return seen


def _run_single(arch, monkeypatch, **kw):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    tcfg = TrainConfig(remat=False, **kw)
    state = init_train_state(cfg, tcfg, device="cpu")
    names = [n for n, _ in state["params"].named_parameters()]
    seen = _step_spy(monkeypatch)
    step = make_train_step(cfg, tcfg, "cpu")
    stream = TokenStream(cfg.vocab_size, 16, 4, seed=0)
    metrics = []
    for i in range(2):
        state, m = step(state, stream.batch_at(i))
        metrics.append(m)
    return names, seen, metrics


@pytest.mark.parametrize("kw", [{}, {"microbatch": 2},
                                {"grad_compress": True}])
def test_single_device_moe_norm_is_the_slab_terms(monkeypatch, kw):
    """deepseek-moe-16b's single-device step: the norm handed to AdamW
    (and reported) is the expert stacks' slab terms summed beside every
    other leaf's square sum, in leaf order, and within ``NORM_RTOL`` of a
    float64 recount of the gradients."""
    from repro_torch.optim.adamw import square_sum

    names, seen, metrics = _run_single("deepseek-moe-16b", monkeypatch, **kw)
    experts = [n for n in names if n.rsplit(".", 1)[-1] in (
        "moe_w_in", "moe_w_out")]
    assert len(experts) == 2
    for (grads, gnorm), m in zip(seen, metrics):
        assert torch.equal(m["grad_norm"], gnorm)
        want = torch.sqrt(sum(
            torch.sum(slab_square_sums(g)) if n in experts else square_sum(g)
            for n, g in zip(names, grads)))
        assert torch.equal(gnorm, want)
        ref = float(np.sqrt(sum(float((g.double() ** 2).sum())
                                for g in grads)))
        assert abs(float(gnorm) - ref) <= NORM_RTOL * ref


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-3b"])
def test_dense_and_ssm_norms_keep_their_association(monkeypatch, arch):
    """Families without expert stacks: the norm is ``global_norm`` of the
    gradients, bit for bit, as the step took it before."""
    _, seen, _ = _run_single(arch, monkeypatch)
    for grads, gnorm in seen:
        assert torch.equal(gnorm, global_norm(grads))
