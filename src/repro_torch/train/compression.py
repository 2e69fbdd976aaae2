"""Int8 error-feedback gradient compression (the reference's
``train/compression.py``).

Each gradient leaf is quantized to int8 against a per-leaf float32 scale,
with an error-feedback accumulator carrying what the rounding lost into
the next step.  :func:`compressed_dp_mean` is the reference's compressed
data-parallel mean on a mesh of ranks: each rank quantizes its own data
shard's gradients, the int8 codes (sent as int8) are summed as int32
over the data axes (exact, so the order of the sum does not matter) and
the scales' maximum taken, and the mean is ``summed * s_max / n_dp`` in
the reference's order of operations.  :func:`compressed_mean_local` is its one-shard form.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32 0-d)``: ``scale = max|x| / 127 + 1e-12``,
    ``q = clip(round(x / scale), -127, 127)`` (round half to even).  Both
    divisions are tensor by tensor (a true division, as XLA's).  ``amax``:
    ``max|x|`` given, when ``x`` is a share of the leaf (the whole leaf's;
    a maximum is exact under any split)."""
    if amax is None:
        amax = torch.amax(torch.abs(x))
    scale = amax / x.new_tensor(127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_grads(grads: list, error: list, leaf_max=None):
    """Apply error feedback and quantize.  Returns ``(q8, scales,
    new_error)``, lists in the order of ``grads``.  ``leaf_max``: maps a
    share's ``max|x|`` to its whole leaf's (shares of split leaves)."""
    qs, ss, es = [], [], []
    for g, e in zip(grads, error):
        corrected = g.float() + e
        amax = None
        if leaf_max is not None:
            amax = leaf_max(torch.amax(torch.abs(corrected)))
        q, s = quantize_int8(corrected, amax)
        qs.append(q)
        ss.append(s)
        es.append(corrected - dequantize_int8(q, s))
    return qs, ss, es


def _mean(summed: list, s_max: list, n_dp: int) -> list:
    """``float32(summed) * s_max / n_dp``, the division tensor by tensor
    (a true division, as XLA's)."""
    div = s_max[0].new_tensor(float(n_dp)) if s_max else None
    return [q.float() * s / div for q, s in zip(summed, s_max)]


def compressed_mean_local(grads: list, error: list):
    """The compressed mean over one data shard: ``(mean, new_error)``,
    ``mean = int32(q) * scale / n_dp`` with ``n_dp = 1``."""
    q8, scales, new_e = ef_compress_grads(grads, error)
    return _mean([q.to(torch.int32) for q in q8], scales, 1), new_e


def compressed_dp_mean(grads: list, error: list, mesh, dp_axes: tuple,
                       share_axes: tuple = ()):
    """Error-feedback int8 mean over the data axes ``dp_axes`` of
    ``mesh`` (every rank of the mesh calls it with its own data shard's
    full gradients and its error buffers, lists in one order): ``(mean,
    new_error)``, the mean equal on every rank, ``new_error`` the rank's
    own (what its rounding lost).  The codes travel as int8, one member's
    at a time, into int32 sums (the reference's ``psum`` of the codes as
    int32 is the same sum: integers add exactly in any order).
    ``share_axes``: the leaves are the rank's shares of leaves split over
    these axes (moe expert stacks over the model axis), each scale taken
    from the whole leaf's ``max|x|`` (the shares' maximum over the axes);
    everything else is elementwise given the scale, so a rank's results
    are bit for bit its slices of the whole leaves'."""
    from repro_torch.nn.sharding import all_reduce, each_member

    axes = tuple(a for a in dp_axes if a in mesh.axis_names)
    n_dp = 1
    for a in axes:
        n_dp *= mesh.shape[a]

    def leaf_max(amax):
        for a in share_axes:
            all_reduce(amax, mesh, a, op="max")
        return amax

    q8, scales, new_e = ef_compress_grads(grads, error,
                                          leaf_max if share_axes else None)
    summed = []
    for q in q8:
        acc = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
        for m in each_member(q, mesh, axes):
            acc.add_(m.to(torch.int32))
        summed.append(acc)
    s_max = torch.stack(scales) if scales else None
    if s_max is not None:
        for a in axes:
            all_reduce(s_max, mesh, a, op="max")
    return _mean(summed, list(s_max.unbind()) if scales else [], n_dp), new_e
