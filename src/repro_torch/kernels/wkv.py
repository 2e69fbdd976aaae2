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
reference does); :func:`wkv_cuda` launches ``csrc/wkv.cu``, which keeps
the state in shared memory and sums the pairwise terms directly.  The
launch wrapper that picks between them by the input's device is
:func:`repro_torch.kernels.ops.wkv`.
"""
from __future__ import annotations

import ctypes

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


def wkv_cuda(q, k, v, log_w, u, chunk: int, state=None):
    """Launch K8 on contiguous float32 card tensors (the wrapper in
    :mod:`.ops` validates); returns ``(y, final state)``."""
    from . import build

    b, t, h, n = q.shape
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=q.device)
    s = torch.empty((b, h, n, n), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = build.entry("rlut_wkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        y.data_ptr(), s.data_ptr(), b, t, h, n, chunk,
        ctypes.c_void_p(stream))
    check_status("wkv", status)
    return y, s
