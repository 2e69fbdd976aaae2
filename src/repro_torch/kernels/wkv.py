"""Chunked RWKV6 WKV: kernel K8 and its plain version.

Counterpart of the reference's ``kernels/wkv.py`` (``wkv_pallas``) and of
the function it is the Pallas form of, ``nn/ssm.py::wkv_chunked``.  Per
chunk of ``C`` steps, with ``Lc`` the inclusive cumsum of ``log_w`` and
``Lc_{i-1} = Lc_i - log_w_i`` (every exponent <= 0)::

    y_i = sum_{j<i} (q_i . k_j e^{Lc_{i-1} - Lc_j}) v_j
          + (q_i . (u * k_i)) v_i + (q_i e^{Lc_{i-1}}) @ S
    S'  = e^{Lc_last} * S + sum_j (k_j e^{Lc_last - Lc_j})^T v_j

:func:`wkv_chunked_plain` is the reference's ``wkv_chunked`` written in
PyTorch (it builds the ``(B, C, C, H, N)`` pairwise-decay tensor, as the
reference does); :func:`wkv_cuda` launches ``csrc/wkv.cu`` with the plan
of :func:`k8_plan`: a thread-block cluster per (batch, head), each CTA
with a share of the value columns and its slice of the state in shared
memory, the pairwise matrix computed once per cluster in 16-step
sub-chunks with bounded decay.  The launch wrapper that picks between
them by the input's device is :func:`repro_torch.kernels.ops.wkv`.

K8b, the backward (training), is :func:`wkv_backward_plain` (the
recurrence's backward written in PyTorch, two sequential passes) and
:func:`wkv_backward_cuda` (``csrc/wkv_bwd.cu``, chunk-parallel on the
tensor cores with the plan of :func:`k8b_plan`);
:func:`repro_torch.kernels.ops.wkv_backward` picks between them, and
``ops.wkv`` is differentiable through them.
:func:`wkv_backward_chunked_plain` models the kernel's chunked algorithm
on the CPU for the tests.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .abstract import is_abstract
from .lut_act import check_status


def wkv_chunked_plain(q, k, v, log_w, u, chunk: int = 16, state=None):
    """Plain K8.  ``q``/``k``/``v``/``log_w`` ``(B, T, H, N)``, ``u``
    ``(H, N)``, ``state`` ``(B, H, N, N)`` or ``None`` (zeros).  Returns
    ``(y (B, T, H, N) f32, final state (B, H, N, N) f32)``.  A ragged T is
    padded with zero q, k, v and log_w (decay 1), which changes neither
    the outputs nor the state."""
    b, t_orig, h, n = q.shape
    f32 = lambda a: a.float()
    q, k, v, log_w = map(f32, (q, k, v, log_w))
    u = f32(u)
    pad = (-t_orig) % chunk
    if pad:
        zpad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        q, k, v, log_w = zpad(q), zpad(k), zpad(v), zpad(log_w)
    t = q.shape[1]
    nc = t // chunk
    resh = lambda a: a.reshape(b, nc, chunk, h, n)
    qs, ks, vs, lws = map(resh, (q, k, v, log_w))
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=q.device)
         if state is None else f32(state))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device), diagonal=-1)
    ys = []
    for c in range(nc):
        qc, kc, vc, lw = qs[:, c], ks[:, c], vs[:, c], lws[:, c]
        lc = torch.cumsum(lw, dim=1)                          # (B, C, H, N)
        diff = (lc - lw)[:, :, None] - lc[:, None, :]         # (B,C,C,H,N)
        dec = torch.where(mask[None, :, :, None, None], torch.exp(diff),
                          torch.zeros((), device=q.device))
        a = torch.einsum("bihn,bjhn,bijhn->bhij", qc, kc, dec)
        y = torch.einsum("bhij,bjhn->bihn", a, vc)
        diag = torch.einsum("bihn,bihn->bih", qc, u[None, None] * kc)
        y = y + diag[..., None] * vc
        q_t = qc * torch.exp(lc - lw)
        y = y + torch.einsum("bihn,bhnm->bihm", q_t, s)
        ltot = lc[:, -1:]
        k_dec = kc * torch.exp(ltot - lc)
        s = torch.exp(ltot[:, 0])[..., None] * s + torch.einsum(
            "bjhn,bjhm->bhnm", k_dec, vc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, t, h, n)
    return y[:, :t_orig], s


# sub-chunk length (csrc/wkv.cu kSub), threads per CTA, and the shared
# memory a CTA of an H100 may take (227 KB) and an SM holds (228 KB, 1 KB
# of it reserved per CTA)
K8_SUB = 16
K8_THREADS = 256
K8_CLUSTER = 2
K8_SMEM_LIMIT = 232448
SM_SMEM = 233472


def _round4(x: int) -> int:
    return (x + 3) & ~3


def k8_col_stride(cols: int) -> int:
    """Row stride of the v and state slices in shared memory: 8 mod 32
    floats (``csrc/wkv.cu::col_stride``)."""
    return cols + ((8 - cols % 32) + 32) % 32


def k8_smem_bytes(n: int, chunk: int, cols: int) -> int:
    """Shared memory of one CTA (``csrc/wkv.cu::wkv_smem_floats``): the
    cumsum and its shift (``chunk x (n + 4)`` each, later the decayed k
    and q, which the kernel reads from device memory), the pairwise
    matrix, the state slice, one region for the pairwise blocks' scratch
    (pre-scaled q and k, or a diagonal block's partial sums) and then the
    chunk's v slice, u and the cumsum's last row."""
    cs = k8_col_stride(cols)
    scratch = max(K8_SUB * (n + 4) + _round4(n * (K8_SUB + 1)),
                  K8_SUB * (K8_SUB + 1) // 2 * (n // 4 + 1))
    region = max(scratch, chunk * cs)
    return 4 * (2 * chunk * (n + 4) + chunk * (_round4(chunk) + 4)
                + n * cs + _round4(region) + 2 * n)


@dataclasses.dataclass(frozen=True)
class K8Plan:
    """One K8 launch: ``cluster`` CTAs per (batch, head), each with
    ``cols`` value columns (starting at ``rank * cols``) and its slice of
    the state; chunks of ``chunk`` steps in ``K8_SUB``-step sub-chunks."""

    cluster: int
    cols: int
    chunk: int
    smem_bytes: int
    grid: int
    threads: int = K8_THREADS

    def col_ranges(self) -> list[tuple[int, int]]:
        return [(r * self.cols, (r + 1) * self.cols)
                for r in range(self.cluster)]

    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by shared memory and threads."""
        return min(SM_SMEM // (self.smem_bytes + 1024),
                   2048 // self.threads)


def k8_plan(b: int, t: int, h: int, n: int, chunk: int) -> K8Plan:
    """The launch plan of K8 for ``(B, T, H, N)`` inputs and chunk length
    ``chunk``.  The chunk is at most T (padding rows change nothing); a
    cluster of ``K8_CLUSTER`` CTAs per (batch, head), each with half the
    value columns (32 at rwkv6-3b's N = 64: 320 CTAs of 73.2 KB at its
    prefill, three to an SM, one wave).  On an H100 four CTAs of 16
    columns ran slower at that shape when q and k were staged (640 CTAs
    of 104 KB took three waves), and so did one CTA of 64 columns (one to
    an SM, every pairwise block in one CTA).  Raises where the kernel cannot run: N not
    a multiple of 16 (whole mma tiles) or over 256 (a thread a column in
    its loops), or more shared memory than a CTA may take."""
    if min(b, t, h, n, chunk) < 1 or n % 16 or n > K8_THREADS:
        raise ValueError(f"wkv: K8 needs B, T, H, chunk >= 1 and N a "
                         f"multiple of 16 up to {K8_THREADS}, got "
                         f"{(b, t, h, n)}, chunk {chunk}")
    c = min(chunk, t)
    cols = n // K8_CLUSTER
    smem = k8_smem_bytes(n, c, cols)
    if smem > K8_SMEM_LIMIT:
        raise ValueError(f"wkv: K8 at N {n}, chunk {c} needs {smem} bytes "
                         f"of shared memory a CTA (at most {K8_SMEM_LIMIT})")
    return K8Plan(cluster=K8_CLUSTER, cols=cols, chunk=c, smem_bytes=smem,
                  grid=b * h * K8_CLUSTER)


def wkv_cuda(q, k, v, log_w, u, chunk: int, state=None):
    """Launch K8 on contiguous, 16-byte aligned float32 card tensors (the
    wrapper in :mod:`.ops` validates) with :func:`k8_plan`'s plan;
    returns ``(y, final state)``."""
    from . import build

    b, t, h, n = q.shape
    p = k8_plan(b, t, h, n, chunk)
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=q.device)
    s = torch.empty((b, h, n, n), dtype=torch.float32, device=q.device)
    if is_abstract():
        return y, s
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("rlut_wkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        y.data_ptr(), s.data_ptr(), b, t, h, n, p.chunk, p.cluster,
        p.smem_bytes, ctypes.c_void_p(stream))
    check_status("wkv", status)
    return y, s


# -------------------------------------------------------------------------
# K8b: the backward
# -------------------------------------------------------------------------
K8B_THREADS = 256        # state pass and scan
K8B_GRAD_THREADS = 512   # gradient pass
K8B_SUB = 16             # sub-chunk length (csrc/wkv_bwd.cu kSub)
K8B_CHUNKS = (64, 32, 16)
K8B_HEAD_SIZES = (16, 32, 64, 128)


def k8b_state_smem_bytes(n: int, chunk: int) -> int:
    """Shared memory of one CTA of K8b's first pass (``csrc/wkv_bwd.cu::
    state_smem_floats``): the cumsum and its shift (then k and q decayed
    to the chunk's end and from its start), v and dy, each ``chunk x (n
    + 4)``; four of du's partial sums a thread; beta; the cumsum's last
    row."""
    return 4 * (4 * chunk * (n + 4) + 4 * K8B_THREADS + chunk + n)


def k8b_smem_bytes(n: int, chunk: int) -> int:
    """Shared memory of one CTA of K8b's gradient pass (``csrc/wkv_bwd.cu
    ::grad_smem_floats``): q, k, v, dy, the cumsum and its shift, dq and
    dk's state parts and the anchored operand (``chunk x (n + 4)``
    each), the boundary state and adjoint (``n x (n + 4)`` each), the
    pairwise matrices A and dA (``chunk x (chunk + 4)`` each), beta and
    a (``chunk`` each), u, the cumsum's last row and the dlog_w carry
    (``n`` each)."""
    return 4 * (9 * chunk * (n + 4) + 2 * n * (n + 4)
                + 2 * chunk * (chunk + 4) + 2 * chunk + 3 * n)


@dataclasses.dataclass(frozen=True)
class K8BPlan:
    """One K8b launch: three CUDA kernels on the launching stream.  The
    state pass (``grid`` CTAs of ``K8B_THREADS``, one per (batch, head,
    chunk)) writes each chunk's own state and adjoint contributions and
    du's partial sums; the scan (``scan_grid`` blocks of ``K8B_THREADS``,
    a thread per four entries of a state row) turns them into the
    boundary states, the boundary adjoints, the dlog_w carry and du; the
    gradient pass (``grid`` CTAs of ``K8B_GRAD_THREADS``) gives dq, dk,
    dv and dlog_w.  ``scratch_floats``: three ``(B, H, n_chunks, N, N)``
    arrays and three ``(B, H, n_chunks, N)``."""

    chunk: int
    n_chunks: int
    grid: int
    scan_grid: int
    smem_state: int
    smem_grad: int
    scratch_floats: int

    def ctas_per_sm(self) -> tuple[int, int]:
        """CTAs an SM holds (state pass, gradient pass), by shared memory
        and threads."""
        fit = lambda smem, threads: min(SM_SMEM // (smem + 1024),
                                        2048 // threads)
        return (fit(self.smem_state, K8B_THREADS),
                fit(self.smem_grad, K8B_GRAD_THREADS))


def k8b_plan(b: int, t: int, h: int, n: int) -> K8BPlan:
    """The launch plan of K8b for ``(B, T, H, N)`` inputs: the longest
    chunk of ``K8B_CHUNKS`` whose gradient pass fits a CTA's shared
    memory (64 up to N = 64, 16 at N = 128), whatever T is: a ragged
    last chunk, or a T shorter than the chunk, loads zero rows, which
    change no gradient.  At rwkv6-3b's training shape (4, 256, 40, 64):
    4 chunks, 640 CTAs of 222.25 KB in the gradient pass (one to an SM)
    and of 72.5 KB in the state pass (three), 31.5 MB of scratch.
    Raises where the kernel cannot run: N not in ``K8B_HEAD_SIZES``
    (whole mma tiles, a thread a column), or B, T, H below 1."""
    if min(b, t, h) < 1 or n not in K8B_HEAD_SIZES:
        raise ValueError(f"wkv_backward: K8b needs B, T, H >= 1 and N in "
                         f"{K8B_HEAD_SIZES}, got {(b, t, h, n)}")
    c = next(c for c in K8B_CHUNKS if k8b_smem_bytes(n, c) <= K8_SMEM_LIMIT)
    nc = -(-t // c)
    rows = b * h * nc
    return K8BPlan(chunk=c, n_chunks=nc, grid=rows,
                   scan_grid=-(-b * h * n * (n // 4) // K8B_THREADS),
                   smem_state=k8b_state_smem_bytes(n, c),
                   smem_grad=k8b_smem_bytes(n, c),
                   scratch_floats=rows * (3 * n * n + 3 * n))


def wkv_backward_plain(q, k, v, log_w, u, dy, state=None):
    """Plain K8b: the gradients of :func:`wkv_chunked_plain`'s ``y`` (the
    recurrence ``y_t = q_t S_t + (q_t . (u * k_t)) v_t``, ``S_{t+1} = w_t
    * S_t + k_t v_t^T``) against ``dy = dL/dy``, from the initial
    ``state`` (``None``: zeros).  Two sequential passes in float32, with
    ``w = exp(log_w)``, ``beta_t = dy_t . v_t``, ``a_t = q_t . (u * k_t)``:
    the forward pass rebuilds ``S_t`` and gives ``dq_t = S_t dy_t + (u *
    k_t) beta_t``; the reverse pass carries ``G_t = w_t * G_{t+1} + q_t
    dy_t^T`` from ``G_T = 0`` and gives ``dk_t = G_{t+1} v_t + (q_t * u)
    beta_t`` and ``dv_t = G_{t+1}^T k_t + a_t dy_t``; ``du = sum (q * k)
    beta``; and ``dlog_w_t = sum_{i>t} q_i * dq^st_i - sum_{j>=t} k_j *
    dk^st_j`` with ``dq^st`` / ``dk^st`` the state parts above.  Returns
    ``(dq, dk, dv, dlog_w, du)`` float32 (``du`` (H, N)); float64 inputs
    are computed and returned in float64."""
    b, t, h, n = q.shape
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    q, k, v, log_w, dy, u = (a.to(dt) for a in (q, k, v, log_w, dy, u))
    w = torch.exp(log_w)
    beta = torch.sum(dy * v, dim=-1)[..., None]        # (B, T, H, 1)
    a = torch.sum(q * (u * k), dim=-1)[..., None]
    s = (torch.zeros((b, h, n, n), dtype=dt, device=q.device)
         if state is None else state.to(dt))
    dq = torch.empty_like(q)
    c = torch.empty_like(q)
    for i in range(t):
        dqst = torch.einsum("bhnm,bhm->bhn", s, dy[:, i])
        dq[:, i] = dqst + (u * k[:, i]) * beta[:, i]
        c[:, i] = q[:, i] * dqst
        s = (w[:, i][..., None] * s
             + k[:, i][..., None] * v[:, i][..., None, :])
    g = torch.zeros((b, h, n, n), dtype=dt, device=q.device)
    run_a = torch.zeros((b, h, n), dtype=dt, device=q.device)
    run_b = torch.zeros_like(run_a)
    dk, dv, dlw = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    for i in reversed(range(t)):
        dkst = torch.einsum("bhnm,bhm->bhn", g, v[:, i])
        dvst = torch.einsum("bhnm,bhn->bhm", g, k[:, i])
        dk[:, i] = dkst + (q[:, i] * u) * beta[:, i]
        dv[:, i] = dvst + a[:, i] * dy[:, i]
        run_b = run_b + k[:, i] * dkst
        dlw[:, i] = run_a - run_b
        run_a = run_a + c[:, i]
        g = (w[:, i][..., None] * g
             + q[:, i][..., None] * dy[:, i][..., None, :])
    du = torch.sum(q * k * beta, dim=(0, 1))
    return dq, dk, dv, dlw, du


def wkv_backward_chunked_plain(q, k, v, log_w, u, dy, chunk: int,
                               state=None):
    """A model of K8b's chunked algorithm (``csrc/wkv_bwd.cu``) in plain
    PyTorch, step for step, for the tests: it computes what
    :func:`wkv_backward_plain` computes, and nothing on the card's path
    calls it.  Per chunk of ``chunk`` steps (a multiple of ``K8B_SUB``;
    T padded with zero rows), ``Lc`` the inclusive cumsum of ``log_w``,
    ``Lc_{i-1} = Lc_i - log_w_i`` and ``L`` the last row:

    * state pass: each chunk's own contributions ``U = (k e^{L - Lc})^T
      v`` to the state at its end and ``W = (q e^{Lc_{i-1}})^T dy`` to
      the adjoint at its start;
    * scan: the adjoint at each chunk's end ``G_c`` (``G_{c-1} = e^L G_c
      + W_c`` from zero) with ``Y_c = rowsum(G_c U_c)``, then the state
      at each chunk's start ``S_c`` (``S_{c+1} = e^L S_c + U_c`` from
      ``state``) with ``X_c = rowsum(S_c W_c)``; the dlog_w carry of
      chunk c is ``sum_{c' > c} (X_c' - Y_c')``, the later chunks' sums
      of ``q dq^st - k dk^st`` (their within-chunk pairs cancel);
    * gradient pass: ``dA = dy v^T``; dq's and dk's state parts
      ``e^{Lc_{i-1}} (S_c dy_i)`` and ``e^{L - Lc_j} (G_c v_j)``; per
      anchor b (the last row of each sub-chunk but the last), ``X_b`` =
      ``k e^{Lc_b - Lc}`` on rows up to b and ``q e^{Lc_{i-1} - Lc_b}``
      after it, which gives the next sub-chunk's rows of A (``X X^T``),
      of dq (``e^{Lc_{i-1} - Lc_b} (dA X)``) and b's sub-chunk's rows of
      dk (``e^{Lc_b - Lc_j} (dA^T X)``); the diagonal sub-chunk blocks
      directly (A an exp a term; dq and dk with the decay as a running
      product of the steps' ``e^{Lc_r - Lc_{r-1}}``); ``A_jj = a_j``; ``dv = A^T dy + (k e^{L - Lc}) G_c``;
      dlog_w from the within-chunk suffix sums and the carry.

    Every exponent is at most 0.  Returns ``(dq, dk, dv, dlog_w, du)`` as
    :func:`wkv_backward_plain` does (float64 in, float64 out)."""
    b, t_orig, h, n = q.shape
    if chunk < K8B_SUB or chunk % K8B_SUB:
        raise ValueError(f"wkv_backward: the chunk must be a multiple of "
                         f"{K8B_SUB}, got {chunk}")
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    q, k, v, log_w, dy, u = (a.to(dt) for a in (q, k, v, log_w, dy, u))
    pad = (-t_orig) % chunk
    if pad:
        zpad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        q, k, v, log_w, dy = map(zpad, (q, k, v, log_w, dy))
    t = q.shape[1]
    nc, c = t // chunk, chunk
    # (B, H, chunks, C, N)
    tiles = lambda a: a.reshape(b, nc, c, h, n).permute(0, 3, 1, 2, 4)
    q, k, v, lw, dy = map(tiles, (q, k, v, log_w, dy))
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=q.device)
    lc = torch.cumsum(lw, dim=3)
    lx = lc - lw
    last = lc[:, :, :, -1:]                                  # (B,H,nc,1,N)
    # state pass
    kt = k * torch.exp(last - lc)
    ut = torch.einsum("bhcjn,bhcjm->bhcnm", kt, v)
    wt = torch.einsum("bhcin,bhcim->bhcnm", q * torch.exp(lx), dy)
    # scan: G (reverse), then S (forward), then the carry (reverse)
    dec = torch.exp(last[:, :, :, 0])[..., None]             # (B,H,nc,N,1)
    gs, ys, ss, xs = [None] * nc, [None] * nc, [None] * nc, [None] * nc
    g = zeros(b, h, n, n)
    for ci in reversed(range(nc)):
        gs[ci], ys[ci] = g, torch.sum(g * ut[:, :, ci], dim=-1)
        g = dec[:, :, ci] * g + wt[:, :, ci]
    s = zeros(b, h, n, n) if state is None else state.to(dt)
    for ci in range(nc):
        ss[ci], xs[ci] = s, torch.sum(s * wt[:, :, ci], dim=-1)
        s = dec[:, :, ci] * s + ut[:, :, ci]
    carry, run = [None] * nc, zeros(b, h, n)
    for ci in reversed(range(nc)):
        carry[ci] = run
        run = run + (xs[ci] - ys[ci])
    big_s, big_g = torch.stack(ss, dim=2), torch.stack(gs, dim=2)
    carry = torch.stack(carry, dim=2)[:, :, :, None]         # (B,H,nc,1,N)
    # gradient pass
    ub = u[None, :, None, None]
    beta = torch.sum(dy * v, dim=-1)[..., None]              # (B,H,nc,C,1)
    a = torch.sum(q * (ub * k), dim=-1)
    da = torch.einsum("bhcin,bhcjn->bhcij", dy, v)
    dq = torch.exp(lx) * torch.einsum("bhcim,bhcnm->bhcin", dy, big_s)
    dk = torch.exp(last - lc) * torch.einsum("bhcjm,bhcnm->bhcjn", v, big_g)
    am = zeros(b, h, nc, c, c)
    sub = K8B_SUB
    for s_ in range(c // sub - 1):
        r0, r1 = sub * s_, sub * (s_ + 1)        # b's sub-chunk; b = r1 - 1
        lb = lc[:, :, :, r1 - 1:r1]
        xk = k[:, :, :, :r1] * torch.exp(lb - lc[:, :, :, :r1])
        xq = q[:, :, :, r1:] * torch.exp(lx[:, :, :, r1:] - lb)
        rows = slice(r1, r1 + sub)
        am[..., rows, :r1] = torch.einsum("bhcin,bhcjn->bhcij",
                                          xq[..., :sub, :], xk)
        dq[..., rows, :] += torch.exp(lx[..., rows, :] - lb) * torch.einsum(
            "bhcij,bhcjn->bhcin", da[..., rows, :r1], xk)
        dk[..., r0:r1, :] += torch.exp(lb - lc[..., r0:r1, :]) * torch.einsum(
            "bhcij,bhcin->bhcjn", da[..., r1:, r0:r1], xq)
    below = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                  device=q.device), diagonal=-1)[..., None]
    for s_ in range(c // sub):
        r0 = sub * s_
        rows = slice(r0, r0 + sub)
        # A: e^{Lc_{i-1} - Lc_j} a term
        diff = lx[..., rows, None, :] - lc[..., None, rows, :]   # (i, j, N)
        e = torch.exp(diff.masked_fill(~below, -math.inf))       # j < i
        am[..., rows, rows] = torch.sum(q[..., rows, None, :]
                                        * k[..., None, rows, :] * e, dim=-1)
        # dq, dk: the same decay as a running product of the steps'
        # e^{Lc_r - Lc_{r-1}}, r = j + 1 .. i - 1
        w = torch.exp(lc[..., rows, :] - lx[..., rows, :])
        pr = torch.ones_like(w)                     # pr[jj] at row i
        for ii in range(1, sub):
            if ii >= 2:
                pr[..., :ii - 1, :] *= w[..., ii - 1:ii, :]
            pr[..., ii - 1, :] = 1.0
            i, js = r0 + ii, slice(r0, r0 + ii)
            dai = da[..., i, js, None]                           # (jj, 1)
            dq[..., i, :] += torch.sum(dai * (k[..., js, :] * pr[..., :ii, :]),
                                       dim=-2)
            dk[..., js, :] += dai * (q[..., i:i + 1, :] * pr[..., :ii, :])
    am = am + torch.diag_embed(a)
    dv = (torch.einsum("bhcij,bhcim->bhcjm", am, dy)
          + torch.einsum("bhcjn,bhcnm->bhcjm", kt, big_g))
    suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, (3,)), 3), (3,))
    after = torch.nn.functional.pad(suffix(q * dq)[:, :, :, 1:],
                                    (0, 0, 0, 1))           # sum_{i' > i}
    dlw = (after - suffix(k * dk)) + carry
    du = torch.sum(q * k * beta, dim=(0, 2, 3))
    dq = dq + (ub * k) * beta
    dk = dk + (q * ub) * beta
    back = lambda x: x.permute(0, 2, 3, 1, 4).reshape(b, t, h, n)[:, :t_orig]
    return back(dq), back(dk), back(dv), back(dlw), du


def wkv_backward_cuda(q, k, v, log_w, u, dy, state=None):
    """Launch K8b on contiguous float32 card tensors (the wrapper in
    :mod:`.ops` validates) with :func:`k8b_plan`'s plan: its three
    kernels, with their scratch allocated here.  Returns ``(dq, dk, dv,
    dlog_w, du)``."""
    from . import build

    b, t, h, n = q.shape
    p = k8b_plan(b, t, h, n)
    dq, dk, dv, dlw = (torch.empty_like(q) for _ in range(4))
    du = torch.empty((h, n), dtype=torch.float32, device=q.device)
    scratch = torch.empty(p.scratch_floats, dtype=torch.float32,
                          device=q.device)
    if is_abstract():
        return dq, dk, dv, dlw, du
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("rlut_wkv_backward")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        dy.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dlw.data_ptr(), du.data_ptr(), scratch.data_ptr(), b, t, h, n,
        p.chunk, p.smem_state, p.smem_grad, ctypes.c_void_p(stream))
    check_status("wkv_backward", status)
    return dq, dk, dv, dlw, du
