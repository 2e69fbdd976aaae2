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
recurrence's backward written in PyTorch) and :func:`wkv_backward_cuda`
(``csrc/wkv_bwd.cu``); :func:`repro_torch.kernels.ops.wkv_backward` picks
between them, and ``ops.wkv`` is differentiable through them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

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
K8B_THREADS = 256
K8B_STAGE = 16           # steps staged at a time (csrc/wkv_bwd.cu kStage)
K8B_HEAD_SIZES = (16, 32, 64, 128)


def k8b_smem_bytes(n: int) -> int:
    """Shared memory of one K8b CTA (``csrc/wkv_bwd.cu::
    wkv_bwd_smem_floats``): the state with a row stride of N + 1, the
    staged q, k, v, w, dy and q * dq^st, each staged step's beta and a,
    and u."""
    return 4 * (n * (n + 1) + 6 * K8B_STAGE * n + 2 * K8B_STAGE + n)


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


def wkv_backward_cuda(q, k, v, log_w, u, dy, state=None):
    """Launch K8b on contiguous float32 card tensors (the wrapper in
    :mod:`.ops` validates): one CTA of ``K8B_THREADS`` per (batch, head).
    Returns ``(dq, dk, dv, dlog_w, du)``, ``du`` summed over the batch
    from the kernel's per-(batch, head) partial sums."""
    from . import build

    b, t, h, n = q.shape
    if n not in K8B_HEAD_SIZES:
        raise ValueError(f"wkv_backward: K8b needs N in {K8B_HEAD_SIZES}, "
                         f"got {n}")
    dq, dk, dv, dlw = (torch.empty_like(q) for _ in range(4))
    du = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("rlut_wkv_backward")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        dy.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dlw.data_ptr(), du.data_ptr(), b, t, h, n, k8b_smem_bytes(n),
        ctypes.c_void_p(stream))
    check_status("wkv_backward", status)
    return dq, dk, dv, dlw, du.sum(dim=0)
