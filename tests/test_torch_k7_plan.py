"""K7's launch plan and a model of its staged addresses, on the CPU.

The LUT-NN layer kernel (``csrc/lutnn_layer.cu``) cannot run here; what
it is handed is decided in Python (``kernels/lutnn_layer.py::k7_plan``)
and held here:

* the plan, walked as the kernel walks it (block -> its tiles -> the
  (neuron group, row chunk) items of each warp -> lanes -> the rows a lane
  looks up at once), writes every (row, neuron) of the output exactly once
  for B in {1, 7, 300, 5000, 20000, 32768} x N in {1, 5, 13, 32, 40, 128,
  256};
* the staged tile and the wiring fit the shared-memory limit, with codes
  one byte each exactly when ``bits <= 8`` and int32 otherwise;
* the unstaged route is taken exactly when one row of codes and the
  wiring do not fit, or a row holds at most ``K7_SHORT_ROW`` codes; the
  blocks reach the SM count wherever B allows;
* the addresses the kernel forms from byte-narrowed, masked codes equal
  ``pack_addresses`` on in-range codes of the paper models' four layer
  shapes, and the lookups equal the reference's ``lutnn_layer_ref``; a
  model of the whole staged launch (ragged last tiles, the last row
  recomputed past a tile's end) equals the plain version.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import lutnn_layer_ref
from repro_torch.kernels.lutnn_layer import (
    BLOCK_RESERVED_SMEM,
    K7_MAX_ROWS,
    K7_MAX_WARPS,
    K7_SHORT_ROW,
    K7_UNROLL,
    SM_BLOCKS,
    SM_THREADS,
    k7_code_bytes,
    k7_plan,
    k7_staged_plan,
    k7_unstaged_plan,
    lutnn_layer_plain,
    pack_addresses,
)

SMS = 132                 # H100 SXM
SMEM = 232448             # its opt-in dynamic shared memory a block
# (B, P, N, F, bits) of the paper models' first layers (and jsc-2l's second)
PAPER = {"jsc-2l L0": (3000, 16, 32, 3, 4), "jsc-2l L1": (3000, 32, 5, 3, 4),
         "jsc-5l L0": (20000, 16, 128, 2, 7),
         "mnist L0": (5000, 784, 256, 6, 2)}
# the route each takes: unstaged where a row holds 16 codes
PAPER_ROUTES = {"jsc-2l L0": "unstaged", "jsc-2l L1": "narrow",
                "jsc-5l L0": "unstaged", "mnist L0": "narrow"}


def _plan(b, p, n, f, bits, *, smem=SMEM):
    return k7_plan(b, p, n, f, bits, 1 << (bits * f), sm_count=SMS,
                   smem_limit=smem)


def _staged(b, p, n, f, bits, *, smem=SMEM):
    return k7_staged_plan(b, p, n, f, bits, sm_count=SMS, smem_limit=smem)


@functools.lru_cache(maxsize=None)
def _warp_items(items: int, warps: int) -> np.ndarray:
    """The items of a tile in the order the block's warps take them
    (warp w: w, w + warps, ...)."""
    return np.concatenate([np.arange(w, items, warps) for w in range(warps)])


def _walk(b, n, plan):
    """Yield ``(rows, neurons, source rows)`` for every lane's look-ups of
    a staged launch: the output rows it stores, their neurons, and the
    tile rows it reads the codes of (the last row of the tile past its
    end)."""
    warps = plan.threads // 32
    groups = -(-n // 32)
    tiles = -(-b // plan.rows)
    lanes = np.arange(32)
    unroll = np.arange(K7_UNROLL)
    for block in range(plan.blocks):
        for tile in range(block, tiles, plan.blocks):
            r0 = tile * plan.rows
            nrows = min(plan.rows, b - r0)
            items = _warp_items(groups * -(-nrows // K7_UNROLL), warps)
            nn = (items % groups)[:, None, None] * 32 + lanes[None, :, None]
            rr = (items // groups)[:, None, None] * K7_UNROLL + unroll
            nn, rr = np.broadcast_arrays(nn, rr)
            keep = (nn < n) & (rr < nrows)
            src = np.minimum(rr, nrows - 1)
            yield r0 + rr[keep], nn[keep], r0 + src[keep]


def _coverage(b, n, plan) -> np.ndarray:
    """Times the walk stores each (row, neuron) of the output."""
    flat = [rows * n + neurons for rows, neurons, _ in _walk(b, n, plan)]
    return np.bincount(np.concatenate(flat), minlength=b * n).reshape(b, n)


@pytest.mark.parametrize("n", [1, 5, 13, 32, 40, 128, 256])
@pytest.mark.parametrize("b", [1, 7, 300, 5000, 20000, 32768])
def test_k7_plan_covers_every_output_once(b, n):
    plan = _plan(b, 784, n, 6, 2)
    assert plan.route == "narrow"
    assert 1 <= plan.rows <= K7_MAX_ROWS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * K7_MAX_WARPS
    per_sm = min(SM_THREADS // plan.threads, SM_BLOCKS,
                 (SMEM + BLOCK_RESERVED_SMEM)
                 // (plan.smem + BLOCK_RESERVED_SMEM))
    assert 1 <= plan.blocks <= SMS * per_sm
    assert (_coverage(b, n, plan) == 1).all()


@pytest.mark.parametrize("bits,f", [(2, 6), (4, 3), (7, 2), (8, 3), (9, 2),
                                    (12, 2), (24, 1)])
@pytest.mark.parametrize("p", [16, 784, 20000, 60000])
@pytest.mark.parametrize("smem", [48 * 1024, SMEM])
def test_k7_plan_tile_fits_shared_memory(bits, f, p, smem):
    """The dynamic shared memory a staged block takes is the wiring and
    ``rows`` rows of codes at the route's width, within the limit; rows
    are whole look-up chunks wherever more than one chunk fits.  The plan
    is the staged one wherever it fits and a row holds more than
    ``K7_SHORT_ROW`` codes."""
    n = 256
    plan = _plan(5000, p, n, f, bits, smem=smem)
    staged = _staged(5000, p, n, f, bits, smem=smem)
    width = k7_code_bytes(bits)
    if 4 * n * f + p * width > smem:
        assert staged is None and plan == k7_unstaged_plan(5000)
        return
    assert plan == (staged if p > K7_SHORT_ROW else k7_unstaged_plan(5000))
    assert staged.route == ("narrow" if bits <= 8 else "int32")
    assert staged.smem == 4 * n * f + staged.rows * p * width <= smem
    assert staged.rows <= K7_UNROLL or staged.rows % K7_UNROLL == 0


@pytest.mark.parametrize("bits", range(1, 25))
def test_k7_plan_narrows_exactly_when_bits_fit_a_byte(bits):
    for f in range(1, 24 // bits + 1):
        plan = _plan(5000, 784, 100, f, bits)
        assert plan.route == ("narrow" if bits <= 8 else "int32"), (bits, f)
        assert k7_code_bytes(bits) == (1 if bits <= 8 else 4)


@pytest.mark.parametrize("bits,f,n", [(2, 6, 256), (7, 2, 128), (9, 2, 13),
                                      (4, 3, 5000)])
def test_k7_plan_unstaged_exactly_when_one_row_does_not_fit(bits, f, n):
    width = k7_code_bytes(bits)
    p_max = (SMEM - 4 * n * f) // width      # the widest row that fits
    last = _plan(300, p_max, n, f, bits)
    assert last.route != "unstaged" and last.rows == 1
    assert last.smem <= SMEM
    over = _plan(300, p_max + 1, n, f, bits)
    assert over.route == "unstaged"
    assert (over.rows, over.threads, over.blocks, over.smem) == (8, 256, 38,
                                                                 0)


@pytest.mark.parametrize("bits,f,n", [(2, 6, 256), (4, 3, 32), (7, 2, 128),
                                      (9, 2, 13)])
def test_k7_plan_unstaged_where_a_row_holds_few_codes(bits, f, n):
    """Rows of at most ``K7_SHORT_ROW`` codes (64 bytes) go unstaged, as
    jsc-2l L0 and jsc-5l L0 do; one code more and the staged route
    (which fits) is taken."""
    assert K7_SHORT_ROW == 16
    for p in range(1, K7_SHORT_ROW + 8):
        plan = _plan(300, p, n, f, bits)
        staged = _staged(300, p, n, f, bits)
        assert staged is not None
        want = k7_unstaged_plan(300) if p <= K7_SHORT_ROW else staged
        assert plan == want, p


def test_k7_plan_unstaged_grid_covers_every_output_once():
    """The unstaged route: ``ceil(N / 32)`` x ``blocks`` blocks of 32
    neurons x 8 rows, each striding over the rows by the grid's rows."""
    b, n = 70000, 40
    plan = _plan(b, 300000, n, 3, 4)
    assert plan.route == "unstaged" and plan.blocks == 4096
    count = np.zeros((b, n), np.int64)
    rows_per = plan.blocks * plan.rows
    for bx in range(-(-n // 32)):
        nn = bx * 32 + np.arange(32)
        nn = nn[nn < n]
        for start in range(0, b, rows_per):
            rows = np.arange(start, min(b, start + rows_per))
            count[np.ix_(rows, nn)] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("b", [1, 7, 131, 132, 300, 1696, 5000, 20000,
                               32768])
@pytest.mark.parametrize("shape", list(PAPER))
def test_k7_plan_fills_every_sm_where_b_allows(b, shape):
    """Staged: a block a tile, up to the SM count; unstaged: a block
    every 8 rows beside each 32 neurons."""
    _, p, n, f, bits = PAPER[shape]
    plan = _plan(b, p, n, f, bits)
    assert plan.route == PAPER_ROUTES[shape]
    if plan.route == "unstaged":
        assert plan.blocks == -(-b // 8)
    else:
        assert plan.blocks >= min(b, SMS)


# ---------------------------------------------------------------------------
# the staged codes: masked, one byte each
# ---------------------------------------------------------------------------
def _inputs(b, p, n, f, bits, seed, code_hi=None):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, code_hi or 1 << bits, (b, p)).astype(np.int32)
    conn = rng.integers(0, p, (n, f)).astype(np.int32)
    tables = rng.integers(0, 1 << 8, (n, 1 << (bits * f))).astype(np.int32)
    return codes, conn, tables


def _narrowed_addresses(codes, conn, bits):
    """The kernel's (B, N) addresses: codes masked to ``bits`` and stored
    one byte each (int32 past 8 bits), the wiring clamped into ``[0,
    P)``, then packed parent 0 first in 32-bit unsigned arithmetic."""
    dtype = np.uint8 if k7_code_bytes(bits) == 1 else np.uint32
    staged = (codes.astype(np.int64) & ((1 << bits) - 1)).astype(dtype)
    j = np.clip(conn, 0, codes.shape[1] - 1)
    addr = np.zeros((staged.shape[0], conn.shape[0]), np.uint32)
    for k in range(conn.shape[1]):
        addr = (addr << np.uint32(bits)) | staged[:, j[:, k]].astype(
            np.uint32)
    return addr


@pytest.mark.parametrize("shape", list(PAPER))
def test_narrowed_addresses_equal_pack_addresses(shape):
    b, p, n, f, bits = PAPER[shape]
    codes, conn, tables = _inputs(b, p, n, f, bits, seed=b + n)
    assert _staged(b, p, n, f, bits).route == "narrow"
    addr = _narrowed_addresses(codes, conn, bits)
    want = pack_addresses(torch.as_tensor(codes), torch.as_tensor(conn),
                          bits)
    np.testing.assert_array_equal(addr.astype(np.int64), want.numpy())
    got = np.take_along_axis(tables, addr.T.astype(np.int64), axis=1).T
    ref = np.asarray(lutnn_layer_ref(jnp.asarray(codes), jnp.asarray(conn),
                                     jnp.asarray(tables), bits=bits))
    np.testing.assert_array_equal(got, ref)


def test_masked_codes_equal_the_plain_version_on_their_low_bits():
    """Out-of-range codes: the kernel reads their low ``bits`` bits, which
    is the plain version on the masked codes (never a fault)."""
    b, p, n, f, bits = 300, 50, 40, 3, 4
    codes, conn, tables = _inputs(b, p, n, f, bits, seed=9,
                                  code_hi=1 << 30)
    addr = _narrowed_addresses(codes, conn, bits)
    got = np.take_along_axis(tables, addr.T.astype(np.int64), axis=1).T
    want = lutnn_layer_plain(torch.as_tensor(codes & ((1 << bits) - 1)),
                             torch.as_tensor(conn), torch.as_tensor(tables),
                             bits=bits)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("b,p,n,f,bits", [
    (7, 50, 13, 6, 2), (301, 50, 40, 3, 4), (1697, 16, 128, 2, 7),
    (5001, 784, 256, 6, 2), (300, 50, 13, 2, 9), (133, 23, 5, 1, 12)])
def test_staged_launch_model_equals_plain(b, p, n, f, bits):
    """Every lane's look-ups of the walk, with the codes its tile row
    stages: the (B, N) output equals the plain version, with ragged last
    tiles and rows past a tile's end reading the tile's last row."""
    plan = _staged(b, p, n, f, bits)
    assert plan.route == ("narrow" if bits <= 8 else "int32")
    codes, conn, tables = _inputs(b, p, n, f, bits, seed=p * n + bits)
    addr = _narrowed_addresses(codes, conn, bits)
    out = np.full((b, n), -1, np.int64)
    for rows, neurons, src in _walk(b, n, plan):
        out[rows, neurons] = tables[neurons, addr[src, neurons]]
    want = lutnn_layer_plain(torch.as_tensor(codes), torch.as_tensor(conn),
                             torch.as_tensor(tables), bits=bits)
    np.testing.assert_array_equal(out, want.numpy())
