"""K8b, the backward of K8 (RWKV6's chunked WKV), on the CPU: its plain
version (``wkv_backward_plain``) and the differentiable ``ops.wkv``
(an ``autograd.Function``: K8 forward, K8b backward; on the CPU their
plain versions) against ``jax.vjp`` of the reference's
``repro.nn.ssm.wkv_chunked``, the function the reference trains through.

Tolerances:
* the identity K8b computes ``dlog_w`` with (two running sums, no stored
  state) against autograd of the recurrence, in float64: ``1e-12`` of the
  running sums' size, ``sum_t |q_t * dq_t|`` and ``sum_t |k_t * dk_t|``
  (their rounding; at ``log_w = -30`` the exact ``dlog_w`` is about
  ``1e-13`` of them), and ``1e-12`` relative for the other gradients;
* float32 against the reference: ``rtol = atol = 1e-4``, K8's own
  tolerance (the chunked and sequential forms sum in other orders).  At
  ``log_w = -30`` the reference's gradient is NaN — its masked
  ``exp(Lc_{i-1} - Lc_j)`` overflows above the diagonal and ``where``'s
  gradient is ``0 * inf`` there (a test records it) — so that case is held
  against autograd of the recurrence in float64, at the same tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro_torch.kernels import launch_counts, ops, reset_launch_counts
from repro_torch.kernels.wkv import (
    K8_SMEM_LIMIT,
    K8B_HEAD_SIZES,
    k8b_plan,
    k8b_smem_bytes,
    wkv_backward_cuda,
    wkv_backward_plain,
    wkv_chunked_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, H, N, chunk, fixed log_w or None, initial state)
CASES = {
    "T 32 chunk 16": (2, 32, 3, 16, 16, None, False),
    "ragged T 37 chunk 16": (2, 37, 2, 16, 16, None, False),
    "T 64 chunk 64, N 32": (1, 64, 2, 32, 64, None, False),
    "log_w = -e": (2, 24, 2, 16, 16, -math.e, False),
    "log_w = -30": (2, 24, 2, 16, 16, -30.0, False),
    "T 1": (2, 1, 2, 16, 16, None, False),
}


def _inputs(b, t, h, n, fixed=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.normal(size=(b, t, h, n)) for _ in range(4))
    lw = -np.exp(rng.uniform(-3.0, 0.7, size=(b, t, h, n)))
    if fixed is not None:
        lw = np.full_like(lw, fixed)
    u = rng.normal(size=(h, n))
    s0 = rng.normal(size=(b, h, n, n)) * 0.1
    return [a.astype(dtype) for a in (q, k, v, lw, u, dy, s0)]


def _want(q, k, v, lw, u, dy, chunk, fixed):
    """The reference's gradients, or at ``log_w = -30`` (where they are
    NaN) autograd of the recurrence in float64."""
    if fixed == -30.0:
        a64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
               for a in (q, k, v, lw, u)]
        zero = torch.zeros(q.shape[0], q.shape[2], q.shape[3], q.shape[3],
                           dtype=torch.float64)
        return [g.numpy() for g in torch.autograd.grad(
            _recurrence(*a64, zero), a64,
            torch.from_numpy(dy.astype(np.float64)))]
    return _jax_vjp(q, k, v, lw, u, dy, chunk)


def _jax_vjp(q, k, v, lw, u, dy, chunk):
    y, vjp = jax.vjp(lambda *a: jssm.wkv_chunked(*a, chunk=chunk)[0],
                     *map(jnp.asarray, (q, k, v, lw, u)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv", "dlog_w", "du"), got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what}: {name}")


def _recurrence(q, k, v, lw, u, s0):
    """The WKV recurrence step by step (differentiable, any dtype)."""
    s, ys = s0.clone(), []
    for i in range(q.shape[1]):
        y = (torch.einsum("bhn,bhnm->bhm", q[:, i], s)
             + torch.einsum("bhn,bhn->bh", q[:, i],
                            u * k[:, i])[..., None] * v[:, i])
        s = (torch.exp(lw[:, i])[..., None] * s
             + k[:, i][..., None] * v[:, i][..., None, :])
        ys.append(y)
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("fixed", [None, -30.0], ids=["random", "-30"])
def test_k8b_identity_float64(state, fixed):
    """The backward K8b computes (forward rebuild of S, reverse carry of
    G, dlog_w from two running sums) equals autograd of the recurrence in
    float64, with and without an initial state."""
    b, t, h, n = 2, 13, 3, 8
    q, k, v, lw, u, dy, s0 = (torch.from_numpy(a) for a in _inputs(
        b, t, h, n, fixed, dtype=np.float64))
    init = s0 if state else torch.zeros_like(s0)
    args = [a.clone().requires_grad_() for a in (q, k, v, lw, u)]
    want = torch.autograd.grad(_recurrence(*args, init), args, dy)
    got = wkv_backward_plain(q, k, v, lw, u, dy,
                             state=s0 if state else None)
    sums = max(float((q * want[0]).abs().sum(1).max()),
               float((k * want[1]).abs().sum(1).max()))
    for name, g, w in zip(("dq", "dk", "dv", "dlog_w", "du"), got, want):
        assert g.dtype == torch.float64
        scale = sums if name == "dlog_w" else float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-12 * scale, name


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k8b_matches_jax_vjp(case):
    b, t, h, n, chunk, fixed, _ = CASES[case]
    q, k, v, lw, u, dy, _ = _inputs(b, t, h, n, fixed)
    want = _want(q, k, v, lw, u, dy, chunk, fixed)
    got = wkv_backward_plain(*map(torch.from_numpy, (q, k, v, lw, u, dy)))
    _close(got, want, case)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_jax_vjp(case):
    """``ops.wkv`` differentiated on the CPU: its plain forward and the
    plain K8b behind ``torch.autograd``; bf16 inputs take float32
    gradients cast back to bf16 (as the reference's ``astype``)."""
    b, t, h, n, chunk, fixed, _ = CASES[case]
    q, k, v, lw, u, dy, _ = _inputs(b, t, h, n, fixed)
    want = _want(q, k, v, lw, u, dy, chunk, fixed)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lw, u)]
    reset_launch_counts()
    y, _ = ops.wkv(*args, chunk=chunk)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    _close(got, want, case)
    assert launch_counts()["wkv"] == launch_counts()["wkv_backward"] == 0


def test_reference_gradient_is_nan_at_strong_decay():
    """What the ``log_w = -30`` cases are held against instead: the
    reference's ``dlog_w`` there is NaN (``exp`` of the masked, positive
    differences overflows and ``where`` passes ``0 * inf`` back), the
    port's is finite and within K8's tolerance of the float64 recurrence."""
    q, k, v, lw, u, dy, _ = _inputs(2, 24, 2, 16, -30.0)
    ref = _jax_vjp(q, k, v, lw, u, dy, 16)
    assert np.isnan(ref[3]).any()
    assert np.isfinite(ref[0]).all()
    got = wkv_backward_plain(*map(torch.from_numpy, (q, k, v, lw, u, dy)))
    assert all(torch.isfinite(g).all() for g in got)
    _close(got, _want(q, k, v, lw, u, dy, 16, -30.0), "-30")


def test_autograd_matches_autograd_of_the_plain_forward():
    """The function's gradient equals differentiating the plain K8 itself
    (what the port would do without K8b) within K8's tolerance, and its
    forward is the plain forward bit for bit."""
    q, k, v, lw, u, dy, _ = _inputs(2, 40, 2, 16, seed=3)
    a1 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lw, u)]
    a2 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lw, u)]
    y1, _ = ops.wkv(*a1, chunk=16)
    y2, _ = wkv_chunked_plain(*a2, chunk=16)
    assert torch.equal(y1, y2)
    g1 = torch.autograd.grad(y1, a1, torch.from_numpy(dy))
    g2 = torch.autograd.grad(y2, a2, torch.from_numpy(dy))
    _close(g1, [g.numpy() for g in g2], "plain autograd")


def test_bf16_inputs_take_bf16_gradients():
    q, k, v, lw, u, dy, _ = _inputs(1, 16, 2, 16, seed=4)
    args = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
            for a in (q, k, v)] + [torch.from_numpy(lw).requires_grad_(),
                                   torch.from_numpy(u).requires_grad_()]
    y, _ = ops.wkv(*args, chunk=16)
    assert y.dtype == torch.float32
    grads = torch.autograd.grad(y, args, torch.from_numpy(dy))
    assert [g.dtype for g in grads] == [a.dtype for a in args]


def test_initial_state_without_gradient_is_used():
    """A given state that takes no gradient is part of the forward the
    backward rebuilds (the gradients depend on it)."""
    q, k, v, lw, u, dy, s0 = _inputs(2, 20, 2, 16, seed=5)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lw, u)]
    y, _ = ops.wkv(*args, chunk=16, state=torch.from_numpy(s0))
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    a64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
           for a in (q, k, v, lw, u)]
    want = torch.autograd.grad(
        _recurrence(*a64, torch.from_numpy(s0.astype(np.float64))), a64,
        torch.from_numpy(dy.astype(np.float64)))
    _close(got, [w.numpy() for w in want], "initial state")


def test_gradient_into_the_state_is_refused():
    q, k, v, lw, u, dy, s0 = _inputs(1, 8, 2, 16)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, lw, u)]
    with pytest.raises(ValueError, match="initial state"):
        ops.wkv(*args, state=torch.from_numpy(s0).requires_grad_())
    y, s = ops.wkv(*args)
    with pytest.raises(RuntimeError, match="final state"):
        torch.autograd.grad(s.sum(), args)


def test_no_gradient_keeps_the_serving_path():
    """Without a gradient ``ops.wkv`` is the plain forward and builds no
    graph (serving and calibration are unchanged)."""
    q, k, v, lw, u, _, s0 = (torch.from_numpy(a) for a in _inputs(2, 20, 2,
                                                                  16))
    y, s = ops.wkv(q, k, v, lw, u, chunk=16, state=s0)
    y2, s2 = wkv_chunked_plain(q, k, v, lw, u, chunk=16, state=s0)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert y.grad_fn is None


def test_k8b_plan_limits():
    """K8b's plan at rwkv6-3b's N = 64: chunks of 64, the gradient pass's
    shared memory (q, k, v, dy, the cumsum, its shift, dq^st, dk^st and
    the anchored operand at ``64 x 68`` floats, S_c and G_c at ``64 x 68``,
    A and dA at ``64 x 68``, beta, a, u, L and the carry) within a CTA's
    227 KB; other head sizes than 16, 32, 64, 128 are refused before any
    build, and a ``dy`` of another shape by the wrapper."""
    assert K8B_HEAD_SIZES == (16, 32, 64, 128)
    assert k8b_smem_bytes(64, 64) == 4 * (9 * 64 * 68 + 2 * 64 * 68
                                          + 2 * 64 * 68 + 2 * 64 + 3 * 64)
    assert k8b_smem_bytes(64, 64) <= K8_SMEM_LIMIT
    assert k8b_plan(4, 256, 40, 64).chunk == 64
    x = torch.zeros(1, 4, 1, 48)
    with pytest.raises(ValueError, match="N in"):
        wkv_backward_cuda(x, x, x, x, torch.zeros(1, 48), x)
    with pytest.raises(ValueError, match="dy"):
        ops.wkv_backward(x, x, x, x, torch.zeros(1, 48), x[:, :2])
