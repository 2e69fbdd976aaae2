"""The plain versions of the LUT-NN toolflow's kernels (K5
``lut_reconstruct``, K6 ``plain_lookup``, K7 ``lutnn_layer``) against the
reference's Pallas kernels, run as the reference's own tests run them
(interpret mode on the CPU, through ``repro.kernels``), and its
``repro.kernels.ref`` oracles.  Integer gathers: exact equality.

The port's wrappers take CPU tensors here, which go to the plain versions;
the kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TableSpec as JSpec
from repro.core.pipeline import pack_decomposition as j_pack
from repro.core.plan import PlainPlan as JPlain
from repro.core.similarity import make_decomposition as j_decomp
from repro.kernels import PlanArrays as JPlanArrays
from repro.kernels import lut_reconstruct as j_reconstruct
from repro.kernels import lutnn_layer as j_layer
from repro.kernels.ref import (
    lut_reconstruct_ref,
    lutnn_layer_ref,
    plain_lookup_ref,
)
from repro.lutnn.inference import table_forward as j_table_forward
from repro.lutnn.model import LUTNNConfig as JConfig
from repro_torch.core import TableSpec as TSpec
from repro_torch.core.pipeline import pack_decomposition as t_pack
from repro_torch.core.plan import PlainPlan as TPlain
from repro_torch.core.similarity import make_decomposition as t_decomp
from repro_torch.kernels import PlanArrays as TPlanArrays
from repro_torch.kernels import launch_counts, lut_reconstruct, lutnn_layer
from repro_torch.kernels.lutnn_layer import lutnn_layer_plain
from repro_torch.lutnn.inference import table_forward
from repro_torch.lutnn.model import LUTNNConfig as TConfig


def _decomposed(spec_cls, decomp, pack, w_in, w_out, w_lb, m, seed):
    """A guaranteed-decomposed plan (no cost-based plain fallback), built
    with one package's engine, as the reference's golden tests build it."""
    spec = spec_cls.random(w_in, w_out, 0.3, seed, smooth=True)
    hb = spec.values >> w_lb
    lb = (spec.values & ((1 << w_lb) - 1)) if w_lb else None
    d = decomp(hb, spec.care_mask(), m)
    return pack(d, w_in=w_in, w_hb=w_out - w_lb, w_lb=w_lb, lb_values=lb,
                name="g")


def _plans(w_in, w_out, w_lb, m):
    seed = w_in + m
    return (_decomposed(JSpec, j_decomp, j_pack, w_in, w_out, w_lb, m, seed),
            _decomposed(TSpec, t_decomp, t_pack, w_in, w_out, w_lb, m, seed))


def _ref_eq1(x, pa):
    a = pa.arrays
    return np.asarray(lut_reconstruct_ref(
        jnp.asarray(x, jnp.int32), a["t_ust"], a["t_idx"], a["t_rsh"],
        a["t_bias"], a["t_lb"], l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb))


def _port(x, pa):
    out = lut_reconstruct(torch.as_tensor(x, dtype=torch.int32), pa)
    assert out.dtype == torch.int32 and tuple(out.shape) == np.shape(x)
    return out.numpy()


# (w_in, w_out, w_lb, M): the golden tests' geometries (tables shorter than
# a lane, non-lane-aligned) and w_in 8-14 with w_out 4-8, w_lb 0-2
GEOMETRIES = [(5, 4, 0, 4), (5, 6, 2, 8), (6, 5, 1, 8), (9, 8, 3, 16),
              (8, 4, 0, 8), (10, 6, 1, 16), (11, 8, 2, 32), (12, 5, 0, 64),
              (13, 7, 2, 16), (14, 8, 1, 64)]


@pytest.mark.parametrize("w_in,w_out,w_lb,m", GEOMETRIES)
def test_lut_reconstruct_plain_matches_reference_kernel(w_in, w_out, w_lb,
                                                        m):
    jplan, tplan = _plans(w_in, w_out, w_lb, m)
    assert jplan.kind == tplan.kind == "decomposed"
    jpa = JPlanArrays.from_plan(jplan)
    tpa = TPlanArrays.from_plan(tplan, device="cpu")
    assert (tpa.kind, tpa.l, tpa.w_lb, tpa.w_hb) == (jpa.kind, jpa.l,
                                                     jpa.w_lb, jpa.w_hb)
    x = np.arange(1 << w_in)
    got = _port(x, tpa)
    np.testing.assert_array_equal(got, np.asarray(j_reconstruct(
        jnp.asarray(x), jpa)))
    np.testing.assert_array_equal(got, _ref_eq1(x, jpa))
    np.testing.assert_array_equal(got, tplan.reconstruct())


@pytest.mark.parametrize("shape", [(), (1,), (1000,), (3, 37)],
                         ids=["scalar", "one", "1000", "3x37"])
@pytest.mark.parametrize("geometry", [(6, 6, 1, 8), (12, 8, 2, 32)],
                         ids=["w6", "w12"])
def test_lut_reconstruct_plain_query_shapes(shape, geometry):
    jplan, tplan = _plans(*geometry)
    jpa = JPlanArrays.from_plan(jplan)
    tpa = TPlanArrays.from_plan(tplan, device="cpu")
    x = np.random.default_rng(len(shape)).integers(0, 1 << geometry[0],
                                                   size=shape)
    got = _port(x, tpa)
    want = np.asarray(j_reconstruct(jnp.asarray(x), jpa))
    assert want.shape == shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_eq1(x, jpa))


@pytest.mark.parametrize("w_in,w_out", [(5, 3), (7, 6), (10, 8), (12, 4)])
def test_plain_lookup_plain_matches_reference_kernel(w_in, w_out):
    values = JSpec.random(w_in, w_out, 0.0, 2, smooth=False).values
    jpa = JPlanArrays.from_plan(JPlain(values, w_in, w_out))
    tpa = TPlanArrays.from_plan(TPlain(values, w_in, w_out), device="cpu")
    assert tpa.kind == "plain"
    np.testing.assert_array_equal(tpa.arrays["table"].numpy(),
                                  np.asarray(jpa.arrays["table"]))
    rng = np.random.default_rng(w_in)
    for x in (np.arange(1 << w_in), rng.integers(0, 1 << w_in, (3, 37)),
              rng.integers(0, 1 << w_in, ())):
        got = _port(x, tpa)
        np.testing.assert_array_equal(got, np.asarray(j_reconstruct(
            jnp.asarray(x), jpa)))
        np.testing.assert_array_equal(got, np.asarray(plain_lookup_ref(
            jnp.asarray(x, jnp.int32), jnp.asarray(values, jnp.int32))))
    assert launch_counts()["plain_lookup"] == 0   # CPU: no kernel launch


def test_plain_plan_has_no_packed_form():
    plan = TPlain(np.arange(32) % 8, 5, 3)
    with pytest.raises(ValueError, match="packed"):
        TPlanArrays.from_plan(plan, packed=True, device="cpu")
    with pytest.raises(ValueError, match="raw int32"):
        _, tplan = _plans(6, 6, 1, 8)
        lut_reconstruct(torch.arange(4),
                        TPlanArrays.from_plan(tplan, packed=True,
                                              device="cpu"))


def _layer_inputs(b, p, n, f, bits, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << bits, size=(b, p)).astype(np.int32)
    conn = rng.integers(0, p, size=(n, f)).astype(np.int32)
    tables = rng.integers(0, 1 << bits,
                          size=(n, 1 << (bits * f))).astype(np.int32)
    return codes, conn, tables


def _port_layer(codes, conn, tables, bits):
    out = lutnn_layer(torch.as_tensor(codes), torch.as_tensor(conn),
                      torch.as_tensor(tables), bits=bits)
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("b", [1, 7, 300])
@pytest.mark.parametrize("n", [1, 13, 40])
def test_lutnn_layer_plain_sweep_matches_reference_oracle(b, n):
    """Every F in 2-6 and bits in 1-7 with bits * F <= 14, at batch and
    neuron counts off the reference's (128, 8) blocks."""
    cases = [(f, bits) for f in range(2, 7) for bits in range(1, 8)
             if bits * f <= 14]
    assert len(cases) == 18
    for f, bits in cases:
        codes, conn, tables = _layer_inputs(b, 23, n, f, bits,
                                            seed=b * 100 + n + f * bits)
        got = _port_layer(codes, conn, tables, bits)
        want = np.asarray(lutnn_layer_ref(jnp.asarray(codes),
                                          jnp.asarray(conn),
                                          jnp.asarray(tables), bits=bits))
        assert got.shape == (b, n)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,p,n,f,bits", [
    (1, 11, 1, 2, 7),     # every dimension far below a block
    (7, 23, 13, 3, 4),
    (300, 16, 40, 6, 2),  # batch over two blocks, ragged neurons
])
def test_lutnn_layer_plain_matches_reference_kernel(b, p, n, f, bits):
    codes, conn, tables = _layer_inputs(b, p, n, f, bits, seed=b + n)
    got = _port_layer(codes, conn, tables, bits)
    want = np.asarray(j_layer(jnp.asarray(codes), jnp.asarray(conn),
                              jnp.asarray(tables), bits=bits))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,f,t,msg", [
    (5, 5, 1 << 25, "must be in"),     # bits * F = 25 > 24
    (4, 3, 1 << 11, "must be in"),     # tables shorter than 2^(bits*F)
    (0, 3, 1, "must be in"),
])
def test_lutnn_layer_rejects_bad_geometry(bits, f, t, msg):
    codes = torch.zeros((2, 4), dtype=torch.int32)
    conn = torch.zeros((1, f), dtype=torch.int32)
    tables = torch.zeros((1, 1), dtype=torch.int32).expand(1, t)
    with pytest.raises(ValueError, match=msg):
        lutnn_layer(codes, conn, tables, bits=bits)


def test_lutnn_layer_plain_is_the_wrappers_cpu_path():
    codes, conn, tables = _layer_inputs(9, 10, 5, 3, 3, seed=1)
    c, k, t = map(torch.as_tensor, (codes, conn, tables))
    before = launch_counts()["lutnn_layer"]
    assert torch.equal(lutnn_layer(c, k, t, bits=3),
                       lutnn_layer_plain(c, k, t, bits=3))
    assert launch_counts()["lutnn_layer"] == before


@pytest.mark.parametrize("chunk", [4096, 7], ids=["one-chunk", "ragged"])
def test_table_forward_matches_reference_numpy(chunk):
    """A three-layer table network with mixed input widths: the port's
    ``table_forward`` (K7's plain version per layer) gives the reference's
    numpy output codes and the same visited-address masks."""
    kw = dict(name="tf", n_inputs=10, layer_sizes=(9, 6, 4), beta=2,
              fanin=3, beta0=3, fanin0=2, seed=3)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    rng = np.random.default_rng(7)
    conn, tables = [], []
    prev = kw["n_inputs"]
    for l, n in enumerate(kw["layer_sizes"]):
        f, w = jcfg.layer_fanin(l), jcfg.layer_w_in(l)
        conn.append(rng.integers(0, prev, (n, f)).astype(np.int32))
        tables.append(rng.integers(0, 1 << jcfg.beta,
                                   (n, 1 << w)).astype(np.int32))
        prev = n
    x = rng.integers(0, 1 << jcfg.beta0, (50, kw["n_inputs"]))
    j_obs = [np.zeros(t.shape, bool) for t in tables]
    want = j_table_forward(tables, conn, jcfg, x, observers=j_obs)
    t_obs = [torch.zeros(t.shape, dtype=torch.bool) for t in tables]
    got = table_forward([torch.as_tensor(t) for t in tables],
                        [torch.as_tensor(c) for c in conn], tcfg,
                        torch.as_tensor(x), chunk=chunk, observers=t_obs)
    np.testing.assert_array_equal(got.numpy(), want)
    for a, b in zip(t_obs, j_obs):
        np.testing.assert_array_equal(a.numpy(), b)
