"""One layer of a LUT network (K7), with its plain version and its plan.

Counterpart of the reference's ``kernels/lutnn_layer.py``: K7
``lutnn_layer`` replaces ``lutnn_layer_pallas``.  For parent codes
``codes (B, P)``, wiring ``conn (N, F)`` and truth tables ``tables (N, T)``
(all int32), output ``out[b, n] = tables[n, addr]`` with
``addr = sum_k codes[b, conn[n, k]] << bits * (F - 1 - k)`` (parent 0 is
the most significant).  The kernel is ``csrc/lutnn_layer.cu``; its launch
geometry comes from :func:`k7_plan`; the launch wrapper lives in
:mod:`.ops`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .lut_act import check_status, sm_count

MAX_ADDR_BITS = 24   # bits * F; the paper's models need at most 14

# the C interface's routes (csrc/lutnn_layer.cu, enum Route)
K7_ROUTES = {"unstaged": 0, "narrow": 1, "int32": 2}
K7_UNROLL = 4          # rows a lane looks up at once (kUnroll)
K7_MAX_WARPS = 8       # warps per staged block at most (kMaxThreads / 32)
K7_ITEMS_PER_WARP = 2  # (neuron group, row chunk) items a warp takes a tile
K7_MAX_ROWS = 256      # rows per tile at most
K7_UNSTAGED_ROWS = 8   # rows per unstaged block (kUnstagedB)
K7_UNSTAGED_MAX_BLOCKS = 4096
# codes a row at most that go unstaged: 64 bytes, two sectors that L1
# keeps for every 32-neuron block of the unstaged route, so staging them
# saves no reads and costs its barrier
K7_SHORT_ROW = 16
# an SM of sm_90: 2048 resident threads, 32 resident blocks, and shared
# memory of the opt-in limit plus the 1 KB the card reserves per block
SM_THREADS, SM_BLOCKS, BLOCK_RESERVED_SMEM = 2048, 32, 1024


class K7Plan(NamedTuple):
    """A K7 launch: ``route`` ``"narrow"`` (codes staged one byte each),
    ``"int32"`` (staged as int32) or ``"unstaged"``; ``rows`` per tile;
    ``threads`` per block; ``blocks`` (staged: blocks that stride over
    the ``ceil(B / rows)`` tiles; unstaged: the grid's row dimension,
    beside ``ceil(N / 32)`` neuron blocks); ``smem``: dynamic
    shared-memory bytes a block."""

    route: str
    rows: int
    threads: int
    blocks: int
    smem: int


def k7_code_bytes(bits: int) -> int:
    """Shared-memory bytes of one staged code: one where ``bits <= 8``
    (exact: only the low ``bits`` bits enter the address), else four."""
    return 1 if bits <= 8 else 4


def k7_unstaged_plan(b: int) -> K7Plan:
    """The unstaged launch for ``b`` rows: blocks of 32 neurons x
    :data:`K7_UNSTAGED_ROWS` rows, ``blocks`` of them down the rows
    (at most :data:`K7_UNSTAGED_MAX_BLOCKS`, striding over the rest)."""
    blocks = min(max(1, -(-b // K7_UNSTAGED_ROWS)), K7_UNSTAGED_MAX_BLOCKS)
    return K7Plan("unstaged", K7_UNSTAGED_ROWS, 32 * K7_UNSTAGED_ROWS,
                  blocks, 0)


def k7_staged_plan(b: int, p: int, n: int, f: int, bits: int, *,
                   sm_count: int, smem_limit: int) -> K7Plan | None:
    """The staged launch for codes ``(b, p)`` and wiring ``(n, f)``, or
    ``None`` where not even one row of codes fits beside the wiring.

    A staged block holds the wiring (``4 * n * f`` bytes) and a tile of
    ``rows`` rows of codes (``rows * p`` code bytes, four times that
    where ``bits > 8``).  ``rows``: enough that each of
    :data:`K7_MAX_WARPS` warps takes :data:`K7_ITEMS_PER_WARP` (neuron
    group of 32, chunk of :data:`K7_UNROLL` rows) items of a tile, in
    whole chunks; fewer where ``b`` would leave an SM without a tile
    (down to one row) or the tile would not fit ``smem_limit``.
    ``threads``: one warp per item of a tile, at most
    :data:`K7_MAX_WARPS`.  ``blocks``: one a tile, at most as many as the
    card holds at once (by threads and shared memory); the blocks stride
    over the rest, so the SMs end within a tile of each other."""
    width = k7_code_bytes(bits)
    wiring = 4 * n * f
    fit = (smem_limit - wiring) // (p * width)
    if fit < 1:
        return None
    sms = max(1, sm_count)
    groups = max(1, -(-n // 32))
    rows = K7_UNROLL * -(-K7_ITEMS_PER_WARP * K7_MAX_WARPS // groups)
    rows = min(rows, K7_MAX_ROWS, fit, max(1, b // sms))
    if rows > K7_UNROLL:
        rows -= rows % K7_UNROLL
    threads = 32 * min(K7_MAX_WARPS, groups * -(-rows // K7_UNROLL))
    smem = wiring + rows * p * width
    per_sm = min(SM_THREADS // threads, SM_BLOCKS,
                 (smem_limit + BLOCK_RESERVED_SMEM)
                 // (smem + BLOCK_RESERVED_SMEM))
    blocks = max(1, min(-(-b // rows), sms * per_sm))
    return K7Plan("narrow" if width == 1 else "int32", rows, threads,
                  blocks, smem)


@functools.lru_cache(maxsize=1024)   # pure: one plan per shape, cached
def k7_plan(b: int, p: int, n: int, f: int, bits: int, t: int, *,
            sm_count: int, smem_limit: int) -> K7Plan:
    """The launch of K7 for codes ``(b, p)``, wiring ``(n, f)`` and tables
    ``(n, t)`` on a card of ``sm_count`` SMs whose blocks may take
    ``smem_limit`` bytes of dynamic shared memory (the opt-in limit):
    :func:`k7_staged_plan`'s, or :func:`k7_unstaged_plan`'s where a row
    holds at most :data:`K7_SHORT_ROW` codes or not even one row of codes
    fits beside the wiring."""
    if b < 0 or n < 0 or p < 1 or f < 1 or bits < 1 or \
            bits * f > MAX_ADDR_BITS or t < 1 << (bits * f):
        raise ValueError(f"k7_plan: no K7 launch for B={b} P={p} N={n} "
                         f"F={f} bits={bits} T={t}")
    if p > K7_SHORT_ROW:
        staged = k7_staged_plan(b, p, n, f, bits, sm_count=sm_count,
                                smem_limit=smem_limit)
        if staged is not None:
            return staged
    return k7_unstaged_plan(b)


@functools.lru_cache(maxsize=None)
def smem_optin(device: torch.device) -> int:
    """Dynamic shared memory a block of the card may opt in to, bytes."""
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def pack_addresses(codes: torch.Tensor, conn: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """The (B, N) int64 table addresses of one layer (parent 0 = MSB)."""
    f = conn.shape[1]
    gathered = codes[:, conn.long()].long()        # (B, N, F)
    addr = torch.zeros(gathered.shape[:-1], dtype=torch.int64,
                       device=codes.device)
    for k in range(f):
        addr |= gathered[..., k] << (bits * (f - 1 - k))
    return addr


def lutnn_layer_plain(codes: torch.Tensor, conn: torch.Tensor,
                      tables: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Plain K7: (B, N) int32 output codes."""
    addr = pack_addresses(codes, conn, bits)
    return torch.gather(tables, 1, addr.T).T.contiguous().to(torch.int32)


def lutnn_layer_cuda(codes: torch.Tensor, conn: torch.Tensor,
                     tables: torch.Tensor, *, bits: int,
                     plan: K7Plan | None = None) -> torch.Tensor:
    """Launch K7 on contiguous int32 tensors on one card, as ``plan``
    says (by default :func:`k7_plan`'s for the shape)."""
    from . import build

    b, p = codes.shape
    n, f = conn.shape
    t = tables.shape[1]
    dev = codes.device
    if plan is None:
        plan = k7_plan(b, p, n, f, bits, t, sm_count=sm_count(dev),
                       smem_limit=smem_optin(dev))
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    check_status("lutnn_layer", build.entry("rlut_lutnn_layer")(
        codes.data_ptr(), conn.data_ptr(), tables.data_ptr(),
        out.data_ptr(), b, p, n, f, t, bits, K7_ROUTES[plan.route],
        plan.rows, plan.threads, plan.blocks,
        ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev.index))))
    return out
