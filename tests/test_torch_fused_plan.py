"""The tile and split plan of K3's tensor-core route (``k3_plan``), on the
CPU: the kernel cannot run here, but what it is told to do is decided in
Python and held here.

For every serving shape (qwen3-0.6b's gated MLP and rwkv6-3b's non-gated
``ffn`` at full width, M = 4 and 256) and the smoke configurations' shapes:
the plan does not depend on the epilogue, the split-K slices cover K once
in order, the output tiles cover every column once with gate ``j`` and up
``F + j`` in one tile, at most 8 slices (8 blocks to a cluster), and at
M = 4 the full-width grids fill the card's 132 SMs.  Shapes TMA cannot
describe raise.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.fused_matmul_lut import (
    K3_BLOCK_K,
    K3_MAX_SPLITS,
    k3_launch,
    k3_plan,
)
from repro_torch.nn.layers import is_gated

SMS = 132   # an H100 SXM


def _site_shape(cfg):
    """(K, N, gated) of the site K3 serves: the MLP's fused [gate|up] for
    a gated activation, rwkv's ``w_ffn_k`` otherwise."""
    gated = is_gated(cfg.activation)
    return cfg.d_model, (2 if gated else 1) * cfg.d_ff, gated


def _shapes():
    out = []
    for arch in ("qwen3-0.6b", "rwkv6-3b"):
        for label, cfg in (("full", get_config(arch)),
                           ("smoke", smoke_config(get_config(arch)))):
            k, n, gated = _site_shape(cfg)
            for m in (4, 256):
                out.append(pytest.param(m, k, n, gated,
                                        id=f"{arch}-{label}-M{m}"))
    return out


SHAPES = _shapes()


def _plan(m, k, n, gated):
    return k3_plan(m, k, n, gated=gated, dtype=torch.bfloat16, sm_count=SMS)


def test_serving_shapes_are_the_published_widths():
    """The full-width shapes are those PERF.md times: qwen3-0.6b 1024 x
    6144 gated, rwkv6-3b 2560 x 8960 non-gated."""
    assert _site_shape(get_config("qwen3-0.6b")) == (1024, 6144, True)
    assert _site_shape(get_config("rwkv6-3b")) == (2560, 8960, False)


@pytest.mark.parametrize("m,k,n,gated", SHAPES)
def test_plan_independent_of_epilogue(m, k, n, gated):
    """The launch with and the launch without the epilogue run the same
    plan (so the same sum order): only the output's shape differs."""
    with_epi, shape_epi = k3_launch(m, k, n, gated=gated, epilogue=True,
                                    dtype=torch.bfloat16, sm_count=SMS)
    without, shape_gemm = k3_launch(m, k, n, gated=gated, epilogue=False,
                                    dtype=torch.bfloat16, sm_count=SMS)
    assert with_epi == without == _plan(m, k, n, gated)
    assert shape_epi == (m, n // 2 if gated else n)
    assert shape_gemm == (m, n)


@pytest.mark.parametrize("m,k,n,gated", SHAPES)
def test_slices_cover_k_once_in_order(m, k, n, gated):
    p = _plan(m, k, n, gated)
    sl = p.slices()
    assert 1 <= p.splits <= K3_MAX_SPLITS and len(sl) == p.splits
    assert sl[0][0] == 0 and sl[-1][1] == k
    for (lo, hi), (lo2, _) in zip(sl, sl[1:]):
        assert hi == lo2
    for lo, hi in sl:
        assert lo < hi and lo % K3_BLOCK_K == 0


@pytest.mark.parametrize("m,k,n,gated", SHAPES)
def test_tiles_cover_every_column_once(m, k, n, gated):
    p = _plan(m, k, n, gated)
    seen = []
    for tile in range(p.col_tiles):
        cols = p.tile_columns(tile)
        if gated:
            f = n // 2
            gate = [c for c in cols if c < f]
            assert sorted(c - f for c in cols if c >= f) == gate
        seen += cols
    assert sorted(seen) == list(range(n))
    assert p.tok_tile * p.tok_tiles >= m > p.tok_tile * (p.tok_tiles - 1)


@pytest.mark.parametrize("m,k,n,gated", [s for s in SHAPES
                                         if "full" in s.id])
def test_grid_fills_the_card(m, k, n, gated):
    """At decode the output tiles are split along K until the grid fills
    132 SMs; at prefill the tiles fill it already and K is not split."""
    p = _plan(m, k, n, gated)
    blocks = p.grid[0] * p.grid[1]
    assert blocks >= SMS
    if m == 256:
        assert p.splits == 1
    else:
        assert p.splits > 1


@pytest.mark.parametrize("m,k,n,gated,what", [
    (4, 1020, 6144, True, "K"),
    (4, 1024, 6140, True, "N"),
    (4, 2562, 8960, False, "K"),
    (4, 2560, 8966, False, "N"),
    (0, 1024, 6144, True, "empty"),
])
def test_shapes_tma_cannot_describe_raise(m, k, n, gated, what):
    with pytest.raises(ValueError):
        _plan(m, k, n, gated)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_tensor_core_route_takes_bf16_only(dtype):
    """The plan refuses another dtype; the float32 launch takes the
    CUDA-core route, which has no plan."""
    with pytest.raises(ValueError):
        k3_plan(4, 1024, 6144, gated=True, dtype=dtype, sm_count=SMS)
    if dtype == torch.float32:
        plan, shape = k3_launch(4, 1024, 6144, gated=True, epilogue=True,
                                dtype=dtype, sm_count=SMS)
        assert plan is None and shape == (4, 3072)


@pytest.mark.parametrize("m", [1, 3, 5, 67, 257])
def test_ragged_shapes_plan(m):
    """The chip check's ragged cases: F = 1000 and K = 1032 are
    described; every k block lands in exactly one slice."""
    for k, n in ((1024, 2000), (1032, 6144)):
        p = _plan(m, k, n, True)
        covered = sum(hi - lo for lo, hi in p.slices())
        assert covered == k and p.splits <= p.k_blocks
