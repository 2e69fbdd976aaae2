"""The port's LUT evaluators (plain versions of kernels K1, K2, K3) against
the JAX reference on the CPU.

The same slabs feed both packages (reference slabs carried across with
``bridge.tables_from_jax``).  The reference runs its Pallas kernels in
interpret mode (``repro.kernels.ops``) and its gather form
(``repro.nn.mlp.lut_act_jnp*``) under ``jax.jit``, as its serving steps run
it — op by op, without jit, XLA keeps the true division and two roundings
in the dequantize and the gather form differs from its own kernels in the
last bit.  The port runs its wrappers on CPU tensors,
which take the plain versions.  K1/K2 must agree bit for bit on every
quantizer bin edge and its neighbours, in float32 and bfloat16, on raw and
bit-packed slabs, on a stack that mixes a ``w_lb == 0`` layer with a
``w_lb > 0`` one.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import PlanArrays as JPlanArrays
from repro.kernels import ops as jops
from repro.kernels.fused_matmul_lut import fused_matmul_lut as j_fused
from repro.nn import mlp as jmlp
from repro.nn.lut_act import build_lut_activation
from repro.serve.stacked import StackedPlanArrays as JStacked
from repro_torch.bridge import tables_from_jax
from repro_torch.kernels import launch_counts, ops as tops
from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain
from repro_torch.kernels.lut_act import (
    fma_f32,
    lut_act_plain,
    lut_act_stacked_plain,
)

X_LO, X_HI, W_IN = -8.0, 8.0, 10


def to_np(tree):
    """JAX arrays -> numpy, python metadata untouched."""
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


@pytest.fixture(scope="module")
def luts():
    rng = np.random.default_rng(0)
    lut0 = build_lut_activation("silu", rng.normal(size=20000) * 2,
                                lb_candidates=(0,))
    lut2 = build_lut_activation("silu", rng.normal(size=20000) * 3,
                                lb_candidates=(2,))
    assert lut0.plan.w_lb == 0 and lut2.plan.w_lb == 2
    return [lut0, lut2]


@pytest.fixture(scope="module")
def stack(luts):
    entries = [{"meta": l.meta(),
                "arrays": JPlanArrays.from_plan(l.plan).arrays}
               for l in luts]
    return JStacked.from_entries(entries)


def edge_inputs(dtype) -> np.ndarray:
    """float32 values at every bin edge of the input quantizer and two
    steps of the input dtype to each side, plus uniform values over and
    beyond the domain — all exactly representable in ``dtype``."""
    levels = (1 << W_IN) - 1
    k = np.arange(levels + 1)
    grid = X_LO + np.concatenate([(k[:-1] + 0.5), k]) / levels * (X_HI - X_LO)
    rng = np.random.default_rng(1)
    base = np.concatenate([grid, rng.uniform(-9.0, 9.0, 2048),
                           [X_LO, X_HI, -20.0, 20.0, 0.0]])
    t = torch.from_numpy(base.astype(np.float32)).to(dtype)
    ibits = torch.int32 if dtype == torch.float32 else torch.int16
    bits = t.view(ibits)
    vals = [(bits + d).view(dtype) for d in (-2, -1, 0, 1, 2)]
    out = torch.cat(vals).float().numpy()
    return out[np.isfinite(out)]


def _jax_in(x32: np.ndarray, dtype):
    x = jnp.asarray(x32)
    return x.astype(jnp.bfloat16) if dtype == torch.bfloat16 else x


def _bits(y) -> np.ndarray:
    """Output bits, widened exactly to float32."""
    if isinstance(y, torch.Tensor):
        return y.float().numpy().view(np.int32)
    return np.asarray(jnp.asarray(y).astype(jnp.float32)).view(np.int32)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_stacked_plain_bitexact_at_bin_edges(stack, dtype, packed):
    """Plain K1 == reference Pallas stacked kernel (interpret) == reference
    gather form, for both layers of a mixed-``w_lb`` stack."""
    x32 = edge_inputs(dtype)
    xj = _jax_in(x32, dtype)
    xt = torch.from_numpy(x32).to(dtype)
    entry_t = tables_from_jax(to_np(stack.entry(packed=packed)),
                              device="cpu")
    raw_j = stack.entry()
    assert entry_t["meta"]["any_lb"]
    for layer in range(stack.n_layers):
        ref_kernel = jops.lut_act_stacked(xj, stack.entry(packed=packed),
                                          layer, interpret=True)
        ref_gather = jax.jit(
            lambda v: jmlp.lut_act_jnp_stacked(v, raw_j, layer))(xj)
        got = tops.lut_act_stacked(xt, entry_t, layer)
        assert got.dtype == dtype
        np.testing.assert_array_equal(_bits(got), _bits(ref_kernel))
        np.testing.assert_array_equal(_bits(got), _bits(ref_gather))
    assert launch_counts()["lut_act_stacked"] == 0   # CPU: plain version


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_per_plan_plain_bitexact_at_bin_edges(luts, dtype, packed):
    """Plain K2 == reference ``lut_act_pallas`` (interpret) == reference
    ``lut_act_jnp``, on a ``w_lb == 0`` and a ``w_lb > 0`` plan."""
    x32 = edge_inputs(dtype)
    xj = _jax_in(x32, dtype)
    xt = torch.from_numpy(x32).to(dtype)
    for lut in luts:
        meta = lut.meta()
        pa_j = JPlanArrays.from_plan(lut.plan, packed=packed)
        ref_kernel = jops.lut_act(xj, pa_j, x_lo=meta["x_lo"],
                                  x_hi=meta["x_hi"], y_lo=meta["y_lo"],
                                  y_hi=meta["y_hi"], interpret=True)
        raw = JPlanArrays.from_plan(lut.plan).arrays
        ref_gather = jax.jit(lambda v: jmlp.lut_act_jnp(v, raw, **meta))(xj)
        arrays_t = tables_from_jax(to_np(pa_j.arrays), device="cpu")
        pa_t = tops.PlanArrays(kind="decomposed", w_in=pa_j.w_in,
                               w_out=pa_j.w_out, l=pa_j.l, w_lb=pa_j.w_lb,
                               w_hb=pa_j.w_hb, arrays=arrays_t,
                               pack=pa_j.pack)
        got = tops.lut_act(xt, pa_t, x_lo=meta["x_lo"], x_hi=meta["x_hi"],
                           y_lo=meta["y_lo"], y_hi=meta["y_hi"])
        direct = lut_act_plain(xt, arrays_t, pack=pa_j.pack, **meta)
        np.testing.assert_array_equal(_bits(got), _bits(direct))
        np.testing.assert_array_equal(_bits(got), _bits(ref_kernel))
        np.testing.assert_array_equal(_bits(got), _bits(ref_gather))


def test_stacked_equals_per_plan(stack, luts):
    """The stacked form of layer i gives the bits of layer i's per-plan
    form (the dequant span is rounded to f32 the same way in both)."""
    x = torch.from_numpy(edge_inputs(torch.float32))
    entry = tables_from_jax(to_np(stack.entry()), device="cpu")
    for i, lut in enumerate(luts):
        arrays = tables_from_jax(
            to_np(JPlanArrays.from_plan(lut.plan).arrays), device="cpu")
        np.testing.assert_array_equal(
            _bits(lut_act_stacked_plain(x, entry, i)),
            _bits(lut_act_plain(x, arrays, **lut.meta())))


def _fma_exact(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """Correctly rounded f32 fma from exact rationals (ties to even)."""
    r = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(r))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - r),
                                     int(np.array(v).view(np.int32)) & 1))
    return best


def test_fma_f32_is_single_rounding():
    """``fma_f32`` equals the exact rational result rounded once, also
    where the product and the addend are far apart in exponent (the
    float64 sum alone would round twice there)."""
    rng = np.random.default_rng(2)
    n = 400
    a = (rng.integers(0, 1 << 16, n)).astype(np.float32)
    b = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-30, 5, n)).astype(
        np.float32)
    c = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-40, 20, n)).astype(
        np.float32)
    # products that sit half an f32 ulp off an addend: the double-rounding
    # trap for a plain float64 sum
    c[:50] = (a[:50].astype(np.float64) * b[:50] * (1 + 2.0 ** -25)
              ).astype(np.float32)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _fused_tab(stack, packed, layer):
    return {"stacked": stack.entry(packed=packed), "layer": layer}


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_fused_plain_bitexact_on_exact_sums(stack, gated, dtype):
    """Plain K3 == reference ``fused_matmul_lut`` (interpret).  Inputs are
    small multiples of 1/2 and 1/4 with K = 16, so every partial sum is
    an exact multiple of 1/8 below 16 — exact in float32 and bfloat16 in
    any order — and the two GEMMs agree whatever their summation order."""
    rng = np.random.default_rng(3)
    b, t, k, f = 2, 3, 16, 40
    n = 2 * f if gated else f
    x = (rng.integers(-3, 4, (b, t, k)) * 0.5).astype(np.float32)
    w = (rng.integers(-2, 3, (k, n)) * 0.25).astype(np.float32)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for layer in range(stack.n_layers):
        ref = j_fused(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd),
                      _fused_tab(stack, True, layer), gated=gated,
                      interpret=True)
        tab_t = tables_from_jax(to_np(_fused_tab(stack, True, layer)),
                                device="cpu")
        got = tops.fused_matmul_lut(torch.from_numpy(x).to(dtype),
                                    torch.from_numpy(w).to(dtype), tab_t,
                                    gated=gated)
        assert got.shape == (b, t, f) and got.dtype == dtype
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert launch_counts()["fused_matmul_lut"] == 0


def test_fused_plain_random_inputs_within_stated_tolerance(stack):
    """On random float32 inputs the two GEMMs may sum in other orders, so
    a GEMM output at a quantizer edge can flip to the neighbouring bin:
    at most 1% of the outputs may differ, and the rest agree bit for
    bit."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 96)) * 0.3).astype(np.float32)
    ref = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(w),
                             _fused_tab(stack, False, 1), gated=True,
                             interpret=True))
    tab_t = tables_from_jax(to_np(_fused_tab(stack, False, 1)),
                            device="cpu")
    got = fused_matmul_lut_plain(torch.from_numpy(x).reshape(16, 64),
                                 torch.from_numpy(w), tab_t,
                                 gated=True).reshape(2, 8, 48).numpy()
    assert np.mean(got != ref) <= 0.01


def test_fused_epilogue_false_is_the_gemm(stack):
    """``epilogue=False`` returns the GEMM alone, rounded to the dtype."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(32, 20)).astype(np.float32))
    tab_t = tables_from_jax(to_np(_fused_tab(stack, True, 0)), device="cpu")
    h = tops.fused_matmul_lut(x, w, tab_t, gated=True, epilogue=False)
    torch.testing.assert_close(h, x @ w, rtol=0, atol=0)
