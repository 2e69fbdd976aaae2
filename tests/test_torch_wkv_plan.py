"""K8's launch plan and its sub-chunk factorization, on the CPU.

The chunked-WKV kernel (``csrc/wkv.cu``) cannot run here; what it is told
to do is decided in Python (``k8_plan``) and held here, and the arithmetic
it runs is modelled in plain PyTorch (:func:`wkv_subchunk_model`, written
in the kernel's order: the cumsum of each column in row order (as
``torch.cumsum`` takes a leading dimension: in float32 on the card, where
the kernel is held to the plain version, and with a float64 carry on the
CPU, where the model is), ``Lc_{i-1}`` as ``Lc_i - log_w_i`` (the plain
version's rounding), diagonal blocks with
the direct per-element decay, off-diagonal blocks as products of q and k
pre-scaled about the row before the block's sub-chunk).

* ``k8_plan`` at rwkv6-3b's full prefill shape and at the smoke
  configuration's: the CTAs of a cluster cover the N value columns once,
  the cluster has 1, 2, 4 or 8 CTAs, a CTA takes at most 227 KB of shared
  memory and at least two fit on an SM, and the full-width grid has at
  least 132 CTAs and runs in one wave (three CTAs to an SM).
* The model, in float64, equals a float64 step-by-step recurrence to
  1e-10; in float32 it is within 1e-5 of ``wkv_chunked_plain`` and, at a
  small shape, of the reference's ``wkv_chunked`` and ``wkv_scan_ref``
  (run on the CPU as the reference's own tests run them).  Cases: chunk
  16 and 64, a ragged T, an initial state, and ``log_w`` at the model's
  bound ``-e`` and at ``-30`` on every step; nothing is ever inf or nan.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.wkv import (
    K8_SMEM_LIMIT,
    K8_SUB,
    k8_plan,
    wkv_chunked_plain,
)
from repro_torch.nn.ssm import WKV_CHUNK

SMS = 132   # an H100 SXM


def _prefill_shape(cfg, batch, prompt):
    n = cfg.rwkv_head_dim
    return batch, prompt, cfg.d_model // n, n


FULL = _prefill_shape(get_config("rwkv6-3b"), 4, 64)
SMOKE = _prefill_shape(smoke_config(get_config("rwkv6-3b")), 2, 8)


def test_full_shape_is_the_served_prefill():
    """The full-width shape is the one PERF.md times: 4 requests x 64
    prompt tokens, 40 heads of 64, chunk 64."""
    assert FULL == (4, 64, 40, 64) and WKV_CHUNK == 64


@pytest.mark.parametrize("shape", [FULL, SMOKE], ids=["full", "smoke"])
@pytest.mark.parametrize("chunk", [16, WKV_CHUNK])
def test_plan_covers_columns_and_fits(shape, chunk):
    b, t, h, n = shape
    p = k8_plan(b, t, h, n, chunk)
    assert p.cluster in (1, 2, 4, 8)
    assert p.chunk == min(chunk, t)
    cols = [c for lo, hi in p.col_ranges() for c in range(lo, hi)]
    assert cols == list(range(n))          # every column once, in order
    assert p.cols % 8 == 0                 # whole mma tiles (8 columns)
    assert p.smem_bytes <= K8_SMEM_LIMIT
    assert p.ctas_per_sm() >= 2
    assert p.grid == b * h * p.cluster and p.grid % p.cluster == 0
    if shape == FULL:
        assert p.grid >= SMS


def test_plan_at_full_width_uses_a_two_cta_cluster():
    """rwkv6-3b's prefill: 32 value columns a CTA, 320 CTAs of 73.2 KB,
    three to an SM, so the grid runs in one wave (one block per (batch,
    head) gave 160 blocks of 115.7 KB, one to an SM)."""
    p = k8_plan(*FULL, WKV_CHUNK)
    assert (p.cluster, p.cols, p.grid, p.ctas_per_sm()) == (2, 32, 320, 3)
    assert p.smem_bytes == 73216
    assert p.grid <= SMS * p.ctas_per_sm()


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        k8_plan(1, 8, 1, 24, 8)            # N not a multiple of 16
    with pytest.raises(ValueError):
        k8_plan(1, 8, 1, 272, 8)           # N over a thread a column
    with pytest.raises(ValueError):
        k8_plan(1, 4096, 1, 256, 1024)     # shared memory past 227 KB


# ---------------------------------------------------------------------------
# the kernel's arithmetic, modelled
# ---------------------------------------------------------------------------
def wkv_subchunk_model(q, k, v, log_w, u, *, chunk, state=None,
                       dtype=torch.float64, sub=K8_SUB):
    """K8's arithmetic in plain PyTorch, in ``dtype``: ``(y (B, T, H, N),
    final state (B, H, N, N))``."""
    b, t, h, n = q.shape
    to = lambda a: a.to(dtype).permute(0, 2, 1, 3)     # (B, H, T, N)
    q, k, v, lw = map(to, (q, k, v, log_w))
    u = u.to(dtype)
    c = min(chunk, t)
    s = (torch.zeros((b, h, n, n), dtype=dtype) if state is None
         else state.to(dtype).clone())
    y = torch.zeros((b, h, t, n), dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    for t0 in range(0, t, c):
        rows = min(c, t - t0)
        pad = lambda a: torch.nn.functional.pad(a[:, :, t0:t0 + rows],
                                                (0, 0, 0, c - rows))
        qc, kc, vc, wc = pad(q), pad(k), pad(v), pad(lw)
        lc = torch.cumsum(wc, dim=-2)   # the kernel's column order
        lx = lc - wc                                  # Lc_{i-1}
        a = torch.zeros((b, h, c, c), dtype=dtype)
        for i0 in range(0, c, sub):
            r1 = min(i0 + sub, c)
            # diagonal block: direct decay, j < i (exponent <= 0 there)
            ii = torch.arange(i0, r1)
            below = ii[:, None] > ii[None, :]
            diff = lx[:, :, i0:r1, None] - lc[:, :, None, i0:r1]
            dec = torch.where(below[..., None], torch.exp(
                torch.where(below[..., None], diff, zero)), zero)
            blk = torch.einsum("bhin,bhjn,bhijn->bhij", qc[:, :, i0:r1],
                               kc[:, :, i0:r1], dec)
            bonus = torch.einsum("bhin,hn,bhin->bhi", qc[:, :, i0:r1], u,
                                 kc[:, :, i0:r1])
            blk = blk + torch.diag_embed(bonus)
            a[:, :, i0:r1, i0:r1] = blk
            if i0 == 0:
                continue
            # off-diagonal blocks, anchored at the row before the block
            lb = lc[:, :, i0 - 1:i0]
            qt = qc[:, :, i0:r1] * torch.exp(lx[:, :, i0:r1] - lb)
            for c0 in range(0, i0, sub):
                kt = kc[:, :, c0:c0 + sub] * torch.exp(
                    lb - lc[:, :, c0:c0 + sub])
                a[:, :, i0:r1, c0:c0 + sub] = torch.einsum(
                    "bhin,bhjn->bhij", qt, kt)
        a = torch.tril(a)
        last = lc[:, :, -1:]
        yc = a @ vc + (qc * torch.exp(lx)) @ s
        s = torch.exp(last[:, :, 0])[..., None] * s + (
            kc * torch.exp(last - lc)).transpose(-1, -2) @ vc
        y[:, :, t0:t0 + rows] = yc[:, :, :rows]
    return y.permute(0, 2, 1, 3), s


def wkv_recurrence(q, k, v, log_w, u, state=None, dtype=torch.float64):
    """``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` step by step, with
    ``y_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t``."""
    b, t, h, n = q.shape
    q, k, v, lw = (a.to(dtype) for a in (q, k, v, log_w))
    u = u.to(dtype)
    s = (torch.zeros((b, h, n, n), dtype=dtype) if state is None
         else state.to(dtype).clone())
    ys = []
    for i in range(t):
        qt, kt, vt = q[:, i], k[:, i], v[:, i]
        y = torch.einsum("bhn,bhnm->bhm", qt, s)
        y = y + torch.einsum("bhn,bhn->bh", qt, u * kt)[..., None] * vt
        s = torch.exp(lw[:, i])[..., None] * s + kt[..., None] * vt[
            ..., None, :]
        ys.append(y)
    return torch.stack(ys, 1), s


def _inputs(b, t, h, n, decay, seed, with_state):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, t, h, n)) for _ in range(3))
    if decay == "random":
        lw = -np.exp(rng.uniform(-3.0, 0.7, size=(b, t, h, n)))
    else:
        lw = np.full((b, t, h, n), decay)
    u = rng.normal(size=(h, n))
    s0 = rng.normal(size=(b, h, n, n)) * 0.1 if with_state else None
    as_t = lambda a: None if a is None else torch.from_numpy(
        a.astype(np.float32))
    return tuple(map(as_t, (q, k, v, lw, u))), as_t(s0)


DECAYS = {"random": "random", "minus-e": -math.e, "minus-30": -30.0}
CASES = [pytest.param(t, chunk, decay, st, id=f"T{t}-C{chunk}-{decay}"
                      + ("-state" if st else ""))
         for t, chunk, decay, st in [
             (64, 64, "random", False), (64, 16, "random", True),
             (37, 16, "random", True), (37, 64, "random", False),
             (64, 64, "minus-e", True), (70, 64, "minus-30", True),
             (48, 16, "minus-30", False), (40, 16, "minus-e", False)]]


@pytest.mark.parametrize("t,chunk,decay,with_state", CASES)
def test_model_float64_equals_recurrence(t, chunk, decay, with_state):
    (q, k, v, lw, u), s0 = _inputs(2, t, 2, 8, DECAYS[decay], t + chunk,
                                   with_state)
    ym, sm = wkv_subchunk_model(q, k, v, lw, u, chunk=chunk, state=s0)
    yr, sr = wkv_recurrence(q, k, v, lw, u, state=s0)
    assert torch.isfinite(ym).all() and torch.isfinite(sm).all()
    np.testing.assert_allclose(ym.numpy(), yr.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(sm.numpy(), sr.numpy(), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("t,chunk,decay,with_state", CASES)
def test_model_float32_matches_plain(t, chunk, decay, with_state):
    (q, k, v, lw, u), s0 = _inputs(2, t, 2, 8, DECAYS[decay], t + chunk,
                                   with_state)
    ym, sm = wkv_subchunk_model(q, k, v, lw, u, chunk=chunk, state=s0,
                                dtype=torch.float32)
    yp, sp = wkv_chunked_plain(q, k, v, lw, u, chunk=chunk, state=s0)
    for a in (ym, sm, yp, sp):
        assert torch.isfinite(a).all()
    np.testing.assert_allclose(ym.numpy(), yp.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sm.numpy(), sp.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,chunk,decay", [(20, 16, "random"),
                                           (16, 16, "minus-e"),
                                           (20, 64, "minus-30")])
def test_model_float32_matches_reference(t, chunk, decay):
    """At a small f32 shape, against the reference's chunked form and its
    sequential oracle."""
    (q, k, v, lw, u), _ = _inputs(1, t, 2, 8, DECAYS[decay], 7, False)
    ym, sm = wkv_subchunk_model(q, k, v, lw, u, chunk=chunk,
                                dtype=torch.float32)
    j = [jnp.asarray(a.numpy()) for a in (q, k, v, lw, u)]
    for yr, sr in (jssm.wkv_chunked(*j, chunk=chunk), jssm.wkv_scan_ref(*j)):
        np.testing.assert_allclose(ym.numpy(), np.asarray(yr), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(sm.numpy(), np.asarray(sr), rtol=1e-5,
                                   atol=1e-5)
