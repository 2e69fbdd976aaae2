"""K4's launch record and grid plan, on the CPU.

The multi-site kernel (``csrc/lut_act_multi.cu``) cannot run here; what
it is handed is built in Python and held here, on the all-sites
super-slab of ``tests/test_torch_multisite.py`` (the reference's plans of
the float32 qwen3-0.6b smoke config, w_in 8, w_out 8, carried into the
port's ``MultiSiteSlabs``):

* the record (``MultiLaunch``) is the ``LutRecord`` struct array of the C
  source, and ``K4Segment`` its segment, laid out as C lays them out;
* for every site and layer its record gives what slicing the super-slab
  gives: the component row (base + layer x row bytes), the words of the
  row, the width, offset and codes per word of each component (those of
  ``meta_p``, which the kernel no longer reads), their ``fast_divmod``
  constants and the meta rows;
* its four host-rounded f32 constants are ``meta_f[..., 2:4]`` and
  ``meta_q`` bit for bit (the tables the plain K4 and K3 read);
* ``MultiSiteSlabs.entry()`` attaches a new record to each new entry off
  the CPU and none on it, and K4 off the CPU refuses an entry without one;
* ``k4_plan``, walked as the kernel walks it (a block finds its segment
  by its index, then strides over the segment's 16-byte vectors, head and
  tail elements, or its elements one a unit at decode), covers every
  element of every segment once with every vector load 16-byte aligned:
  the served decode and prefill shapes of qwen3-0.6b form (f), the
  segment lengths ``chip_smoke.py`` launches together, one and eight
  segments, odd counts and misaligned starts;
* it spreads the 5120-element decode launch over every SM and takes 16
  bytes a thread at prefill.
"""
from __future__ import annotations

import ctypes
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import capture_calibration as j_capture
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro_torch.kernels import ops
from repro_torch.kernels.lut_act import (
    K4_THREADS,
    K4Segment,
    LutRecord,
    MultiLaunch,
    fast_divmod,
    k4_plan,
    stacked_record,
)
from repro_torch.kernels.packing import COMPONENTS
from repro_torch.serve.stacked import (
    MultiSiteSlabs,
    StackedPlanArrays,
    multi_site_stacked_entry,
)

SMS = 132   # an H100 SXM
ALL_SITES = ["attn_exp", "mlp", "norm_rsqrt", "rope_table"]


@pytest.fixture(scope="module")
def slabs():
    """The port's super-slab of the reference's all-sites stacks."""
    cfg = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32", lut_sites="all")
    params = j_init(cfg, jax.random.PRNGKey(0))
    calib = j_capture(params, cfg, j_batches(cfg, 1, batch_size=2,
                                             seq_len=8, seed=1), w_in=8)
    plans = j_build(cfg, calib, w_out=8, backend="pallas")
    stacks = {}
    for site, sp in plans.sites.items():
        if not sp.per_layer:
            continue
        st = sp.stacked()
        stacks[site] = StackedPlanArrays(
            n_layers=st.n_layers, w_in=st.w_in, w_out=st.w_out,
            x_lo=st.x_lo, x_hi=st.x_hi, any_lb=st.any_lb,
            arrays={c: np.array(a) for c, a in st.arrays.items()},
            meta_i=np.array(st.meta_i), meta_f=np.array(st.meta_f),
            lens=dict(st.lens))
    ms = MultiSiteSlabs.from_stacks(stacks)
    assert sorted(ms.sites) == ALL_SITES
    return ms


def _k4_record(entry: dict) -> MultiLaunch:
    """K4's record of a CPU entry, built as ``MultiSiteSlabs.entry()``
    builds it off the CPU: from each site's K1 record over its slice."""
    sites = entry["meta"]["sites"]
    return MultiLaunch({s: stacked_record(multi_site_stacked_entry(entry, s))
                        for s in sites}, sites)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_record_layout_is_the_c_struct(slabs):
    """``K4Segment`` mirrors ``csrc/lut_act_multi.cu``'s ``Segment`` (40
    bytes), and the record array holds the sites' 248-byte ``LutRecord``s
    back to back, in super-slab order."""
    off = {name: getattr(K4Segment, name).offset
           for name, _ in K4Segment._fields_}
    assert off == {"x": 0, "y": 8, "n": 16, "site": 24, "block0": 28,
                   "blocks": 32}
    assert ctypes.sizeof(K4Segment) == 40
    rec = _k4_record(slabs.entry(device="cpu"))
    n = len(slabs.sites)
    assert ctypes.sizeof(rec.recs) == n * ctypes.sizeof(LutRecord) == n * 248
    assert [ctypes.addressof(r) for r in rec.recs] == [
        rec.addr + 248 * i for i in range(n)]
    assert rec.site_ids == {s: i for i, s in enumerate(slabs.sites)}
    assert rec.n_layers == slabs.n_layers


def test_record_equals_slicing_the_super_slab(slabs):
    entry = slabs.entry(device="cpu")
    rec = _k4_record(entry)
    sm_all = entry["meta"]["site_meta"]
    for sid, site in enumerate(slabs.sites):
        r = rec.recs[sid]
        sm = sm_all[site]
        assert (r.n_layers, r.meta_i_ld, r.meta_f_ld) == (slabs.n_layers, 3,
                                                          4)
        assert r.any_lb == int(sm["any_lb"])
        for layer in range(slabs.n_layers):
            for c, comp in enumerate(COMPONENTS):
                row = entry["arrays"][comp][sid, layer]
                assert r.base[c] + layer * r.row_words[c] * 4 == \
                    row.data_ptr(), (site, layer, comp)
                words = 0 if comp == "t_lb" and not sm["any_lb"] else \
                    row.numel()
                p = sm["pack"][comp]
                assert (r.n_words[c], r.width[c], r.offset[c],
                        r.per_word[c]) == (words, p["width"], p["offset"],
                                           p["per_word"])
                assert [r.width[c], r.offset[c], r.per_word[c]] == \
                    entry["meta_p"][sid, c].tolist()
                assert (r.div_mul[c], r.div_shift[c]) == fast_divmod(
                    r.per_word[c])
            assert r.meta_i + layer * r.meta_i_ld * 4 == \
                entry["meta_i"][sid, layer].data_ptr()
            assert r.meta_f + layer * r.meta_f_ld * 4 == \
                entry["meta_f"][sid, layer].data_ptr()


def test_record_constants_are_the_meta_tables_bit_for_bit(slabs):
    """x_lo, 1/x_span (every layer's ``meta_f[..., 2:4]``), levels_in and
    1/levels_out (``meta_q``): the constants the kernel used to read on
    the card, now in its parameters."""
    entry = slabs.entry(device="cpu")
    rec = _k4_record(entry)
    mf, mq = entry["meta_f"].numpy(), entry["meta_q"].numpy()
    for sid in range(len(slabs.sites)):
        r = rec.recs[sid]
        for layer in range(slabs.n_layers):
            assert _bits([r.x_lo, r.x_inv_span]).tolist() == \
                _bits(mf[sid, layer, 2:4]).tolist()
        assert _bits([r.levels_in, r.inv_levels_out]).tolist() == \
            _bits(mq[sid]).tolist()


def test_entries_carry_the_k4_record(slabs):
    """Off the CPU (here the meta device: addresses, no storage) each entry
    gets a record of its own site records; a second entry, a new record.
    CPU entries, which the plain version serves, carry none."""
    assert "k4_record" not in slabs.entry(device="cpu")
    a, b = (slabs.entry(device="meta") for _ in range(2))
    for e in (a, b):
        rec = e["k4_record"]
        assert rec.device == torch.device("meta")
        assert rec.records == tuple(e["site_records"][s]
                                    for s in slabs.sites)
        for sid, site in enumerate(slabs.sites):
            assert list(rec.recs[sid].base) == list(
                e["site_records"][site].rec.base)
    assert a["k4_record"] is not b["k4_record"]
    assert a["k4_record"].addr != b["k4_record"].addr


def test_k4_off_the_cpu_needs_the_entry_record(slabs):
    """Off the CPU, K4 only reads the entry's record: an entry without one
    is refused before anything is launched."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="launch record"):
        ops.lut_act_multi({"mlp": x}, slabs.entry(device="cpu"), 0)
    bare = {k: v for k, v in slabs.entry(device="meta").items()
            if k != "k4_record"}
    with pytest.raises(ValueError, match="launch record"):
        ops.lut_act_multi({"mlp": x}, bare, 0)


# ---------------------------------------------------------------------------
# the grid, walked as the kernel walks it
# ---------------------------------------------------------------------------
def _walk(counts, x_addrs, y_addrs, es, plan):
    """Times each element of each segment is evaluated, and whether every
    16-byte load lies on a 16-byte boundary (and every 16-byte store where
    the kernel stores 16 bytes)."""
    threads, vec, blocks = plan
    block0 = np.cumsum((0,) + blocks[:-1])
    total = int(sum(blocks))
    # the kernel's segment search: the count of later segments whose first
    # block this block has reached
    found = np.zeros(total, np.int64)
    for b0 in block0[1:]:
        found += np.arange(total) >= b0
    assert (np.bincount(found, minlength=len(blocks)) == blocks).all()
    aligned = True
    out = []
    for i, (n, xa, ya) in enumerate(zip(counts, x_addrs, y_addrs)):
        head = nv = 0
        if vec > 1:
            head = min(((16 - xa % 16) % 16) // es, n)
            nv = (n - head) // vec
        units = nv + n - nv * vec
        step = blocks[i] * threads
        k = np.arange(step)[:, None] + step * np.arange(
            -(-units // step))[None, :]
        k = k[k < units]
        vk = k[k < nv]
        e = head + vk * vec
        aligned &= bool(np.all((xa + e * es) % 16 == 0))
        if (ya + head * es) % 16 == 0:
            aligned &= bool(np.all((ya + e * es) % 16 == 0))
        u = k[k >= nv] - nv
        se = np.where(u < head, u, head + nv * vec + (u - head))
        elems = np.concatenate([(e[:, None] + np.arange(vec)).ravel(), se])
        out.append(np.bincount(elems, minlength=n))
    return out, aligned


MULTI = (4 * 3072, (1 << 20) + 3, 4, 5120 + 37)   # every segment under
# its block cap; and chip_smoke.py's MULTI_LENGTHS, one segment past it
PAST_CAP = (4 * 3072, (1 << 22) + 3, 4, 5120 + 37)
WALKS = [  # (label, counts, x byte offsets, dtype)
    ("decode attn_exp", (4 * 8 * 2 * 1 * 80,), (0,), torch.float32),
    ("decode norm_rsqrt", (4,), (0,), torch.float32),
    ("decode rope_table", (64,), (0,), torch.float32),
    ("prefill attn_exp", (4 * 8 * 2 * 64 * 64,), (0,), torch.float32),
    ("prefill norm_rsqrt", (4 * 64,), (0,), torch.float32),
    ("prefill rope_table", (64 * 64,), (0,), torch.float32),
    ("prefill attn_exp bf16", (4 * 8 * 2 * 64 * 64,), (0,),
     torch.bfloat16),
    ("multi-segment decode", (5120, 4, 64), (0, 0, 0), torch.float32),
    ("multi-segment f32", MULTI, (0, 4, 8, 12), torch.float32),
    ("multi-segment bf16", MULTI, (2, 0, 6, 14), torch.bfloat16),
    ("past the cap f32", PAST_CAP, (0, 0, 4, 0), torch.float32),
    ("past the cap bf16", PAST_CAP, (0, 2, 0, 0), torch.bfloat16),
    ("eight segments", (1, 7, 37, 5120, 3, 4097, 12288, 9),
     (0, 4, 8, 12, 0, 4, 8, 12), torch.float32),
    ("one odd segment misaligned", (8003,), (6,), torch.bfloat16),
    ("count 1", (1,), (0,), torch.bfloat16),
    ("count 7 misaligned", (7,), (4,), torch.float32),
    ("count 8k + 3", (8 * 1000 + 3,), (0,), torch.bfloat16),
]


@pytest.mark.parametrize("label,counts,offs,dtype", WALKS,
                         ids=[w[0] for w in WALKS])
def test_k4_plan_covers_every_element_once(label, counts, offs, dtype):
    es = dtype.itemsize
    plan = k4_plan(counts, dtype, sm_count=SMS)
    threads, vec, blocks = plan
    assert vec in (1, 16 // es) and len(blocks) == len(counts)
    assert 32 <= threads <= K4_THREADS and threads % 32 == 0
    assert all(1 <= b <= SMS * 2048 // threads for b in blocks)
    x_addrs = [(1 << 30) * (i + 1) + o for i, o in enumerate(offs)]
    y_addrs = [(1 << 30) * (i + 20) for i in range(len(counts))]
    seen, aligned = _walk(counts, x_addrs, y_addrs, es, plan)
    for n, c in zip(counts, seen):
        assert c.shape == (n,) and (c == 1).all(), label
    assert aligned, label


def test_k4_plan_spreads_decode_and_vectorizes_prefill():
    """Decode: the 5120 attention scores one a thread over at least every
    SM (160 blocks of 32), the 4 norm values and 64 rope angles in one or
    two blocks; prefill (form (f)'s 262144 scores): 16 bytes a thread in
    blocks of 128.  The 2^22 + 3 segment ``chip_smoke.py`` launches goes
    past its block cap in both dtypes (the kernel strides)."""
    threads, vec, blocks = k4_plan((5120,), torch.float32, sm_count=SMS)
    assert vec == 1 and blocks[0] >= SMS and (threads, blocks) == (32,
                                                                   (160,))
    assert k4_plan((4,), torch.float32, sm_count=SMS) == (32, 1, (1,))
    assert k4_plan((64,), torch.float32, sm_count=SMS) == (32, 1, (2,))
    assert k4_plan((262144,), torch.float32, sm_count=SMS) == (
        K4_THREADS, 4, (513,))
    assert k4_plan((262144,), torch.bfloat16, sm_count=SMS)[:2] == (
        K4_THREADS, 8)
    for dtype in (torch.float32, torch.bfloat16):
        threads, vec, blocks = k4_plan(PAST_CAP, dtype, sm_count=SMS)
        units = ((1 << 22) + 3) // vec
        assert blocks[1] == SMS * 2048 // threads < units / threads
