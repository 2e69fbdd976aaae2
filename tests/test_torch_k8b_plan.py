"""K8b's launch plan and a model of its chunked algorithm, on the CPU.

The backward kernels (``csrc/wkv_bwd.cu``) cannot run here; what they are
told to do is decided in Python (``k8b_plan``) and held here, and the
arithmetic they run is modelled in plain PyTorch
(``wkv_backward_chunked_plain``: the chunks' state and adjoint
contributions, the boundary scans and the dlog_w carry, the anchored
off-diagonal sub-chunk blocks, the diagonal blocks and the within-chunk
suffix sums).

Tolerances:
* float64 against the sequential backward ``wkv_backward_plain`` (held
  against autograd of the recurrence in ``test_torch_wkv_grad.py``):
  ``1e-12`` of the largest entry, and for dlog_w of its running sums
  ``sum_t |q_t * dq_t|`` and ``sum_t |k_t * dk_t|``, as there;
* float32 against ``jax.vjp`` of the reference's ``wkv_chunked``: ``rtol =
  atol = 1e-4``, K8's tolerance.  At ``log_w = -30`` the reference's
  gradient is NaN (``test_torch_wkv_grad.py`` shows it), so that case is
  held against float64 autograd of the recurrence at the same tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.kernels.wkv import (
    K8_SMEM_LIMIT,
    K8B_CHUNKS,
    K8B_GRAD_THREADS,
    K8B_HEAD_SIZES,
    K8B_SUB,
    K8B_THREADS,
    K8BPlan,
    k8b_plan,
    k8b_smem_bytes,
    k8b_state_smem_bytes,
    wkv_backward_chunked_plain,
    wkv_backward_cuda,
    wkv_backward_plain,
)

SMS = 132   # an H100 SXM
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dq", "dk", "dv", "dlog_w", "du")


def _inputs(b, t, h, n, fixed=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.normal(size=(b, t, h, n)) for _ in range(4))
    lw = -np.exp(rng.uniform(-3.0, 0.7, size=(b, t, h, n)))
    if fixed is not None:
        lw = np.full_like(lw, fixed)
    u = rng.normal(size=(h, n))
    s0 = rng.normal(size=(b, h, n, n)) * 0.1
    return [a.astype(dtype) for a in (q, k, v, lw, u, dy, s0)]


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


def _held_1e12(got, want, q, k):
    """Each gradient within 1e-12 of its largest entry; dlog_w within 1e-12
    of its running sums."""
    sums = max(float((q * want[0]).abs().sum(1).max()),
               float((k * want[1]).abs().sum(1).max()))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        scale = sums if name == "dlog_w" else float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-12 * scale, name


# (B, T, H, N, fixed log_w or None, initial state)
MODEL_CASES = {
    "random decay": (2, 64, 2, 16, None, False),
    "log_w = -e": (2, 64, 2, 16, -math.e, False),
    "log_w = -30": (2, 64, 2, 16, -30.0, False),
    "initial state": (2, 64, 2, 16, None, True),
    "ragged T 37": (2, 37, 2, 16, None, True),
    "T 40": (1, 40, 2, 32, None, True),
    "T 1": (2, 1, 2, 16, None, False),
    "N 64, T 130": (1, 130, 1, 64, None, True),
}


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_float64_equals_sequential_backward(case, chunk):
    """The chunked algorithm K8b runs equals the two sequential passes of
    the plain K8b in float64: every chunk length, decay at random, at the
    model's bound ``-e`` and at ``-30`` on every step, an initial state, a
    ragged last chunk and a T shorter than the chunk (T 40 and T 1 at
    chunk 64)."""
    b, t, h, n, fixed, state = MODEL_CASES[case]
    q, k, v, lw, u, dy, s0 = (torch.from_numpy(a) for a in _inputs(
        b, t, h, n, fixed, dtype=np.float64))
    s0 = s0 if state else None
    want = wkv_backward_plain(q, k, v, lw, u, dy, state=s0)
    got = wkv_backward_chunked_plain(q, k, v, lw, u, dy, chunk, state=s0)
    _held_1e12(got, want, q, k)


# the cases test_torch_wkv_grad.py holds the plain K8b and ops.wkv to:
# (B, T, H, N, chunk, fixed log_w or None)
JAX_CASES = {
    "T 32 chunk 16": (2, 32, 3, 16, 16, None),
    "ragged T 37 chunk 16": (2, 37, 2, 16, 16, None),
    "T 64 chunk 64, N 32": (1, 64, 2, 32, 64, None),
    "log_w = -e": (2, 24, 2, 16, 16, -math.e),
    "log_w = -30": (2, 24, 2, 16, 16, -30.0),
    "T 1": (2, 1, 2, 16, 16, None),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_model_float32_matches_jax_vjp(case):
    """The model in float32 against ``jax.vjp`` of the reference's
    ``wkv_chunked`` at the same chunk (at ``-30``, where the reference's
    gradient is NaN, against float64 autograd of the recurrence)."""
    b, t, h, n, chunk, fixed = JAX_CASES[case]
    q, k, v, lw, u, dy, _ = _inputs(b, t, h, n, fixed)
    if fixed == -30.0:
        a64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_()
               for a in (q, k, v, lw, u)]
        zero = torch.zeros(b, h, n, n, dtype=torch.float64)
        want = [g.numpy() for g in torch.autograd.grad(
            _recurrence(*a64, zero), a64,
            torch.from_numpy(dy.astype(np.float64)))]
    else:
        _, vjp = jax.vjp(lambda *a: jssm.wkv_chunked(*a, chunk=chunk)[0],
                         *map(jnp.asarray, (q, k, v, lw, u)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got = wkv_backward_chunked_plain(
        *map(torch.from_numpy, (q, k, v, lw, u, dy)), chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **TOL,
                                   err_msg=f"{case}: {name}")


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
def test_model_finite_at_minus_30(state):
    """At ``log_w = -30`` on every step the chunk's decay sums to -1920:
    every exponent the model forms stays <= 0, so nothing is inf or NaN in
    float32, and it still equals the plain K8b within K8's tolerance."""
    q, k, v, lw, u, dy, s0 = (torch.from_numpy(a) for a in _inputs(
        2, 100, 2, 16, -30.0))
    s0 = s0 if state else None
    got = wkv_backward_chunked_plain(q, k, v, lw, u, dy, 64, state=s0)
    want = wkv_backward_plain(q, k, v, lw, u, dy, state=s0)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL,
                                   err_msg=name)


def test_model_refuses_a_chunk_off_the_sub_chunk_grid():
    x = torch.zeros(1, 8, 1, 16)
    for chunk in (0, 8, 24, 40):
        with pytest.raises(ValueError, match="multiple of 16"):
            wkv_backward_chunked_plain(x, x, x, x, torch.zeros(1, 16), x,
                                       chunk)


def _train_shape():
    cfg = get_config("rwkv6-3b")
    n = cfg.rwkv_head_dim
    return 4, 256, cfg.d_model // n, n      # chip_smoke.py phase 18


def test_plan_at_rwkv6_3b_training_shape():
    """The plan chip_smoke.py times (phase 18: 4 x 256 tokens, 40 heads of
    64), written out: chunks of 64, 640 CTAs in the state and gradient
    passes (at least 4 waves of 132 SMs' worth: every SM busy), 640
    blocks in the scan, three state CTAs and one gradient CTA to an SM,
    31.9 MB of scratch."""
    b, t, h, n = _train_shape()
    assert (b, t, h, n) == (4, 256, 40, 64)
    p = k8b_plan(b, t, h, n)
    assert p == K8BPlan(chunk=64, n_chunks=4, grid=640, scan_grid=640,
                        smem_state=74240, smem_grad=227584,
                        scratch_floats=7987200)
    assert p.ctas_per_sm() == (3, 1)
    assert p.grid >= 4 * SMS
    assert 4 * p.scratch_floats == 31948800


@pytest.mark.parametrize("n", K8B_HEAD_SIZES)
@pytest.mark.parametrize("t", [1, 40, 64, 201, 256, 4096])
def test_plan_fits_and_covers(n, t):
    """At every head size the chunk is the longest of ``K8B_CHUNKS`` whose
    gradient pass fits a CTA's 227 KB (64 up to N 64, 16 at N 128), a
    multiple of the sub-chunk; the chunks cover T (the last one ragged, or
    T shorter than one chunk); the grids cover every (batch, head, chunk)
    and every four entries of each state row; the diagonal blocks' items
    fit one a thread (C N <= 4096); the scratch holds three N x N and three
    N-vectors a chunk."""
    b, h = 3, 5
    p = k8b_plan(b, t, h, n)
    assert p.chunk in K8B_CHUNKS and p.chunk % K8B_SUB == 0
    assert p.chunk == (64 if n <= 64 else 16)
    for c in K8B_CHUNKS:
        if c > p.chunk:
            assert k8b_smem_bytes(n, c) > K8_SMEM_LIMIT
    assert p.smem_grad == k8b_smem_bytes(n, p.chunk) <= K8_SMEM_LIMIT
    assert p.smem_state == k8b_state_smem_bytes(n, p.chunk) <= K8_SMEM_LIMIT
    assert (p.n_chunks - 1) * p.chunk < t <= p.n_chunks * p.chunk
    assert p.grid == b * h * p.n_chunks
    assert p.scan_grid * K8B_THREADS >= b * h * n * (n // 4)
    assert (p.scan_grid - 1) * K8B_THREADS < b * h * n * (n // 4)
    assert 2 * (p.chunk // K8B_SUB) * n <= K8B_GRAD_THREADS
    assert p.scratch_floats == p.grid * (3 * n * n + 3 * n)
    assert min(p.ctas_per_sm()) >= 1


def test_smem_formulas():
    """The shared-memory formulas ``csrc/wkv_bwd.cu`` checks its arguments
    against (``state_smem_floats`` / ``grad_smem_floats``), at N 64 and
    chunk 64."""
    n, c, p = 64, 64, 68
    assert k8b_state_smem_bytes(n, c) == 4 * (4 * c * p + 4 * 256 + c + n)
    assert k8b_smem_bytes(n, c) == 4 * (9 * c * p + 2 * n * p
                                        + 2 * c * (c + 4) + 2 * c + 3 * n)
    assert k8b_smem_bytes(128, 32) > K8_SMEM_LIMIT


@pytest.mark.parametrize("shape", [(1, 4, 1, 48), (1, 4, 1, 8), (1, 4, 1, 256),
                                   (0, 4, 1, 64), (1, 0, 1, 64),
                                   (1, 4, 0, 64)])
def test_plan_refuses_what_the_kernel_cannot_run(shape):
    with pytest.raises(ValueError, match="K8b needs"):
        k8b_plan(*shape)


@pytest.mark.parametrize("n", [8, 48, 256])
def test_launch_takes_the_plan_before_any_build(n):
    """``wkv_backward_cuda`` asks ``k8b_plan`` first: a head size the kernel
    cannot run raises ``ValueError`` before anything is built or launched
    (a build here would raise nvcc's ``RuntimeError`` instead)."""
    x = torch.zeros(1, 4, 1, n)
    with pytest.raises(ValueError, match="K8b needs"):
        wkv_backward_cuda(x, x, x, x, torch.zeros(1, n), x)
