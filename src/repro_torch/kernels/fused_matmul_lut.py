"""Matmul-epilogue LUT fusion: kernel K3 and its plain version.

Counterpart of the reference's ``kernels/fused_matmul_lut.py``
(``fused_matmul_lut_pallas``): ``act(x @ w)``, or ``act(gate) * up`` over
a fused ``[gate|up]`` weight, with the LUT activation applied while the
GEMM output tile is still on chip (``csrc/fused_matmul_lut.cu``).

The GEMM accumulates in f32 and is rounded to the model dtype before the
quantizer, as in the reference; the gated product is rounded to the model
dtype once more.  The kernel's own accumulation order (k ascending) is not
cuBLAS's, so the kernel is held bit for bit against its own GEMM
(``epilogue=False``) followed by K1, and against the plain version by the
share of outputs that differ (a bin flip where a GEMM output sits at a
quantizer edge).  On inputs whose every partial sum is exact the plain
version is bit-exact against the reference.

The kernel has two routes, chosen by dtype: bf16 runs on the tensor cores
(TMA-fed ``wgmma``, split-K over a thread-block cluster at small M) with
the tile and split plan of :func:`k3_plan`; float32 runs a tiled CUDA-core
GEMM, since the tensor cores would need TF32.  The plan is a pure
function of the shape, the dtype and the card's SM count, never of the
epilogue, so a launch with ``epilogue=False`` sums in the same order as one
with it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .abstract import is_abstract, traced_sm_count
from .lut_act import (
    DTYPE_CODES,
    check_status,
    entry_plan_record,
    lut_act_plain,
    lut_act_stacked_plain,
    sm_count,
)


def stacked_parts(tab: dict):
    """Normalize a resolved site entry to ``(arrays, meta_i, meta_f, layer,
    statics)`` (reference: ``_as_stacked_parts``).

    Three entry shapes arrive here: the stacked per-layer form, the
    multi-site marker (statically sliced out of the shared super-slab) and
    the shared/unrolled per-plan form — the last as a one-layer stack at
    layer 0 with ``meta_i``/``meta_f`` ``None``: its scalars ride in
    ``statics``.  The plain version evaluates these parts; the kernel
    takes the entry's launch record (:func:`lut_record`)."""
    if "multi_entry" in tab:
        from repro_torch.serve.stacked import multi_site_stacked_entry

        st = multi_site_stacked_entry(tab["multi_entry"], tab["site"])
        return (st["arrays"], st["meta_i"], st["meta_f"], tab["layer"],
                st["meta"])
    if "stacked" in tab:
        st = tab["stacked"]
        return (st["arrays"], st["meta_i"], st["meta_f"], tab["layer"],
                st["meta"])
    meta, arrays = tab["meta"], tab["arrays"]
    statics = dict(meta, any_lb=meta["w_lb"] > 0)
    return {c: a[None] for c, a in arrays.items()}, None, None, 0, statics


def lut_record(tab: dict):
    """``(record, layer)`` of K3's epilogue for a resolved site entry: the
    record a stacked entry or a multi-site entry was built with (a missing
    one raises), or a per-plan entry's (``SitePlan.entry`` builds it; an
    entry made without one gets it per call, as K2's direct call does)."""
    if "multi_entry" in tab:
        recs = tab["multi_entry"].get("site_records")
        if recs is None:
            raise ValueError("fused_matmul_lut: the multi-site entry carries "
                             "no launch records; build it with "
                             "MultiSiteSlabs.entry()")
        return recs[tab["site"]], tab["layer"]
    if "stacked" in tab:
        rec = tab["stacked"].get("k1_record")
        if rec is None:
            raise ValueError("fused_matmul_lut: the stacked entry carries no "
                             "launch record; build it with "
                             "StackedPlanArrays.entry()")
        return rec, tab["layer"]
    rec = tab.get("k1_record")
    return (entry_plan_record(tab) if rec is None else rec), 0


def _lut_plain(h, parts):
    arrays, meta_i, meta_f, layer, st = parts
    if meta_i is not None:
        return lut_act_stacked_plain(
            h, {"meta": st, "arrays": arrays, "meta_i": meta_i,
                "meta_f": meta_f}, layer)
    return lut_act_plain(
        h, {c: a[0] for c, a in arrays.items()}, l=st["l"],
        w_lb=st["w_lb"], w_hb=st["w_hb"], w_in=st["w_in"],
        w_out=st["w_out"], x_lo=st["x_lo"], x_hi=st["x_hi"],
        y_lo=st["y_lo"], y_hi=st["y_hi"], pack=st.get("pack"))


def fused_matmul_lut_plain(x2d, w, tab, *, gated: bool,
                           epilogue: bool = True) -> torch.Tensor:
    """Plain K3 on ``(M, K) @ (K, N)``: ``torch.matmul`` in the model dtype
    (one rounding of the f32 accumulation), then the plain LUT."""
    h = torch.matmul(x2d, w)
    if not epilogue:
        return h
    parts = stacked_parts(tab)
    if gated:
        gate, up = h.chunk(2, dim=-1)
        return _lut_plain(gate, parts) * up
    return _lut_plain(h, parts)


# the tensor-core route's fixed geometry (csrc/fused_matmul_lut.cu, tc::)
K3_BLOCK_K = 64                       # k per pipeline stage
K3_BOX_COLS = 64                      # output columns per W box (wgmma M)
K3_TOKEN_TILES = (8, 16, 32)          # wgmma N: tokens per tile
K3_MAX_SPLITS = 8                     # blocks of one cluster (portable)


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """How the bf16 route of K3 cuts ``(M, K) @ (K, N)`` over the card.

    A block owns one output tile: ``col_tile`` columns (64 gate columns
    and the 64 up columns of the same outputs when gated, 128 columns
    otherwise) for ``tok_tile`` tokens, over one of ``splits`` contiguous
    k ranges; the ``splits`` blocks of a tile form one cluster and their
    partial sums are added in slice order.  The grid is ``(col_tiles *
    splits, tok_tiles)``."""

    m: int
    k: int
    n: int
    gated: bool
    tok_tile: int
    splits: int
    stages: int

    @property
    def features(self) -> int:
        return self.n // 2 if self.gated else self.n

    @property
    def col_tile(self) -> int:
        return K3_BOX_COLS if self.gated else 2 * K3_BOX_COLS

    @property
    def col_tiles(self) -> int:
        return -(-self.features // self.col_tile)

    @property
    def tok_tiles(self) -> int:
        return -(-self.m // self.tok_tile)

    @property
    def k_blocks(self) -> int:
        return -(-self.k // K3_BLOCK_K)

    @property
    def grid(self) -> tuple[int, int]:
        return self.col_tiles * self.splits, self.tok_tiles

    def slices(self) -> list[tuple[int, int]]:
        """``[k_lo, k_hi)`` of each split, in reduction order (the kernel's
        formula: slice ``s`` takes k blocks ``s * kb // S`` up to
        ``(s + 1) * kb // S``)."""
        kb, s = self.k_blocks, self.splits
        return [(i * kb // s * K3_BLOCK_K,
                 min(self.k, (i + 1) * kb // s * K3_BLOCK_K))
                for i in range(s)]

    def tile_columns(self, tile: int) -> list[int]:
        """The output columns of ``w`` (0 <= col < N) that output tile
        ``tile`` reads: gate ``j`` beside up ``F + j`` when gated."""
        f, c0 = self.features, tile * self.col_tile
        if self.gated:
            cols = [j for j in range(c0, c0 + K3_BOX_COLS) if j < f]
            return cols + [f + j for j in cols]
        return [j for j in range(c0, c0 + self.col_tile) if j < f]


@functools.lru_cache(maxsize=1024)   # pure: one plan per shape, cached
def k3_plan(m: int, k: int, n: int, *, gated: bool, dtype: torch.dtype,
            sm_count: int) -> K3Plan:
    """The tile and split plan of K3's bf16 route for ``(m, k) @ (k, n)``
    on a card of ``sm_count`` SMs.

    Tokens ride on wgmma's N dimension: the smallest token tile of
    :data:`K3_TOKEN_TILES` that holds ``m``, at most 32.  Where the output
    tiles alone do not fill the card (decode), each tile's k range is cut
    into up to 8 slices, one block each, so every SM streams weights; at
    prefill the split is 1 wherever the tiles already fill it.  A ring of
    4 stages (68-80 KB) keeps a few blocks per SM streaming; where there
    are two blocks or more for every SM, 2 stages (40 KB) let five blocks
    share an SM, so one block's LUT epilogue, which is integer work on 4
    warps, runs beside other blocks' mainloops.  Both choices come from
    timings of the fused kernel at M = 256 on an H100 (PERF.md):
    32-token tiles in a 2-stage ring beat 64-token tiles in a 4-stage one
    at both served shapes.

    Raises ``ValueError`` for what the route cannot describe: a dtype
    other than bfloat16, ``k`` or ``n`` not a multiple of 8 (TMA wants
    16-byte row strides), an empty shape."""
    if dtype != torch.bfloat16:
        raise ValueError(f"k3_plan: the tensor-core route takes bfloat16, "
                         f"got {dtype}")
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"k3_plan: empty shape M={m} K={k} N={n}")
    if k % 8 or n % 8:
        raise ValueError(
            f"k3_plan: K={k} and N={n} must be multiples of 8 (TMA needs "
            f"16-byte row strides for bf16)")
    tok = next((t for t in K3_TOKEN_TILES if t >= m), K3_TOKEN_TILES[-1])
    plan = K3Plan(m, k, n, gated, tok, 1, 4)
    tiles = plan.col_tiles * plan.tok_tiles
    if tiles < sm_count:
        splits = min(K3_MAX_SPLITS, plan.k_blocks, -(-sm_count // tiles))
        return dataclasses.replace(plan, splits=splits)
    if tiles >= 2 * sm_count:
        return dataclasses.replace(plan, stages=2)
    return plan


def k3_launch(m: int, k: int, n: int, *, gated: bool, epilogue: bool,
              dtype: torch.dtype, sm_count: int
              ) -> tuple[K3Plan | None, tuple[int, int]]:
    """``(plan, output shape)`` of one K3 launch: :func:`k3_plan` for
    bf16, ``None`` for the float32 route.  The epilogue changes only the
    output's shape (``(M, F)`` with it, the GEMM's ``(M, N)`` without),
    never the plan, so both launches sum in the same order."""
    plan = None if dtype == torch.float32 else k3_plan(
        m, k, n, gated=gated, dtype=dtype, sm_count=sm_count)
    return plan, (m, (n // 2 if gated else n) if epilogue else n)


def fused_matmul_lut_cuda(x2d, w, tab, *, gated: bool,
                          epilogue: bool = True) -> torch.Tensor:
    """Launch K3 on card tensors (the wrapper in :mod:`.ops` validates):
    the tensor-core route for bf16 with :func:`k3_plan`'s plan, or the
    CUDA-core route for float32.  A bf16 shape or pointer the tensor-core
    route cannot take raises; nothing falls back."""
    from . import build

    m, k = x2d.shape
    n = w.shape[1]
    plan, shape = k3_launch(m, k, n, gated=gated, epilogue=epilogue,
                            dtype=x2d.dtype,
                            sm_count=traced_sm_count(x2d.device, sm_count))
    tile = (0, 0, 0)
    if plan is not None and not is_abstract():
        for name, t in (("x", x2d), ("w", w)):
            if t.data_ptr() % 16:
                raise ValueError(f"fused_matmul_lut: {name}'s data pointer "
                                 f"is not 16-byte aligned (TMA needs it)")
        tile = (plan.tok_tile, plan.splits, plan.stages)
    rec, layer = lut_record(tab) if epilogue else (None, 0)
    if rec is not None and rec.device != x2d.device:
        raise ValueError(f"fused_matmul_lut: tables on {rec.device}, input "
                         f"on {x2d.device} — tables must live on the "
                         f"input's card")
    out = torch.empty(shape, dtype=x2d.dtype, device=x2d.device)
    if is_abstract():
        return out
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    status = build.entry("rlut_fused_matmul_lut")(
        x2d.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, int(gated),
        int(epilogue), DTYPE_CODES[x2d.dtype], *tile,
        None if rec is None else rec.addr, layer, ctypes.c_void_p(stream))
    check_status("fused_matmul_lut", status)
    return out
