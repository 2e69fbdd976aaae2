"""K1's launch record, fast divmod and grid plan, on the CPU.

The LUT kernel (``csrc/lut_act.cu``) cannot run here; what it is handed
is built in Python and held here:

* the launch record of a stacked entry (``stacked_record``), built once
  with the entry, gives at every layer what slicing that layer out of the
  entry gives: the row pointer (base + layer x row bytes), the words of
  the row, the width, offset and codes per word of each component, the
  meta rows, ``any_lb`` and the four host-rounded f32 constants; K2's
  per-plan record likewise, with the plan's scalars;
* every entry builder attaches the record of its own tensors
  (``StackedPlanArrays.entry``, ``MultiSiteSlabs.entry`` and its site
  slices, ``SitePlan.entry``), a new entry gets a new record, K3 finds
  the entry's record (``lut_record``), and K1 on the card refuses an
  entry without one;
* the multiply-high divmod ``take()`` uses in place of ``/`` and ``%``
  equals ``//`` and ``%`` for every codes-per-word value 1..32 and every
  index up to the largest packed row x codes per word + 1;
* ``k1_plan``'s grid, walked as the kernel walks it (rows by
  ``blockIdx.y``, each row's 16-byte vectors then its head and tail
  elements, or its elements one a unit at decode, by ``blockIdx.x``),
  covers every element once, with every
  vector access 16-byte aligned, at the decode and prefill shapes, on the
  ``gate`` half of a ``[gate|up]`` product, at a misaligned start and at
  odd counts;
* the plain K1 on the strided ``gate`` view equals the plain K1 on its
  contiguous copy, bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.lut_act import (
    K1_BLOCKS_PER_SM,
    LutRecord,
    fast_divmod,
    inv_levels_out,
    k1_plan,
    k1_view,
    lut_act_stacked_plain,
    plan_record,
    quant_constants,
    stacked_record,
)
from repro_torch.kernels.packing import COMPONENTS
from repro_torch.nn.lut_act import build_lut_activation
from repro_torch.serve.stacked import MultiSiteSlabs, StackedPlanArrays

SMS = 132   # an H100 SXM
F = 3072    # qwen3-0.6b's d_ff: the gate half of its [gate|up] product


@pytest.fixture(scope="module")
def luts():
    """Engine plans of three layers: w_lb 0, 2 and 1."""
    rng = np.random.default_rng(0)
    return [build_lut_activation("silu", rng.normal(size=20000) * s,
                                 lb_candidates=lb)
            for s, lb in ((2, (0,)), (3, (2,)), (2.5, (1,)))]


@pytest.fixture(scope="module")
def stack(luts):
    return StackedPlanArrays.from_entries(
        [{"meta": l.meta(), "arrays": l.plan_arrays(device="cpu").arrays}
         for l in luts])


def _entries(stack):
    """The stacked entries K1 serves: raw, packed, and a site's slice of
    the multi-site super-slab (its meta_f rows have stride 4)."""
    multi = MultiSiteSlabs.from_stacks({"mlp": stack, "ffn": stack}).entry(
        device="cpu")
    from repro_torch.serve.stacked import multi_site_stacked_entry

    return {"raw": stack.entry(packed=False, device="cpu"),
            "packed": stack.entry(packed=True, device="cpu"),
            "multi-slice": multi_site_stacked_entry(multi, "ffn")}


def _f32_bits(v) -> int:
    return int(np.float32(v).view(np.int32))


def test_record_layout_is_the_c_struct():
    """``LutRecord`` mirrors ``csrc/lut_eval.cuh``'s struct: natural
    alignment, 248 bytes."""
    off = {name: getattr(LutRecord, name).offset for name, _ in
           LutRecord._fields_}
    assert (off["meta_i"], off["meta_f"], off["row_words"],
            off["div_mul"], off["meta_i_ld"], off["x_lo"],
            off["span"]) == (40, 48, 56, 156, 196, 224, 244)
    assert ctypes.sizeof(LutRecord) == 248


def _unpack(pack, comp):
    p = (pack or {}).get(comp)
    return (p["width"], p["offset"], p["per_word"]) if p else (32, 0, 1)


def _constants(rec, meta):
    """The record's four quantizer constants equal the host-rounded ones,
    bit for bit."""
    want = (*quant_constants(meta["w_in"], meta["x_lo"], meta["x_hi"]),
            inv_levels_out(meta["w_out"]))
    got = (rec.x_lo, rec.x_inv_span, rec.levels_in, rec.inv_levels_out)
    assert [_f32_bits(g) for g in got] == [_f32_bits(w) for w in want]


@pytest.mark.parametrize("form", ["raw", "packed", "multi-slice"])
def test_stacked_record_equals_per_layer_args(stack, form):
    entry = _entries(stack)[form]
    meta = entry["meta"]
    rec = stacked_record(entry).rec
    assert rec.n_layers == stack.n_layers
    for layer in range(stack.n_layers):
        for c, comp in enumerate(COMPONENTS):
            row = entry["arrays"][comp][layer]
            assert rec.base[c] + layer * rec.row_words[c] * 4 == \
                row.data_ptr()
            words = 0 if comp == "t_lb" and not meta["any_lb"] else \
                row.numel()
            assert (rec.n_words[c], rec.width[c], rec.offset[c],
                    rec.per_word[c]) == (words,
                                         *_unpack(meta.get("pack"), comp))
            assert (rec.div_mul[c], rec.div_shift[c]) == fast_divmod(
                rec.per_word[c])
        assert rec.meta_i + layer * rec.meta_i_ld * 4 == \
            entry["meta_i"][layer].data_ptr()
        assert rec.meta_f + layer * rec.meta_f_ld * 4 == \
            entry["meta_f"][layer].data_ptr()
    assert rec.any_lb == 1 and meta["any_lb"]
    _constants(rec, meta)
    assert (rec.meta_f_ld == 4) == (form == "multi-slice")


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_plan_record_equals_per_plan_args(luts, packed):
    for lut in luts:
        pa = lut.plan_arrays(packed=packed, device="cpu")
        kw = dict(l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb, w_in=pa.w_in,
                  w_out=pa.w_out, x_lo=lut.x_lo, x_hi=lut.x_hi,
                  y_lo=lut.y_lo, y_hi=lut.y_hi)
        rec = plan_record(pa.arrays, pa.pack, **kw).rec
        assert list(rec.base) == [pa.arrays[c].data_ptr()
                                  for c in COMPONENTS]
        assert (rec.meta_i, rec.meta_f) == (0, 0)
        assert list(rec.row_words) == [0] * 5 and rec.n_layers == 1
        for c, comp in enumerate(COMPONENTS):
            words = 0 if comp == "t_lb" and pa.w_lb == 0 else \
                pa.arrays[comp].numel()
            assert (rec.n_words[c], rec.width[c], rec.offset[c],
                    rec.per_word[c]) == (words, *_unpack(pa.pack, comp))
        assert (rec.l, rec.w_lb, rec.w_hb, rec.any_lb) == (
            pa.l, pa.w_lb, pa.w_hb, int(pa.w_lb > 0))
        _constants(rec, kw)
        assert [_f32_bits(rec.y_lo), _f32_bits(rec.span)] == [
            _f32_bits(np.float32(lut.y_lo)),
            _f32_bits(np.float32(lut.y_hi - lut.y_lo))]


def test_entries_carry_the_record_of_their_tensors(stack):
    """Off the CPU each builder attaches the record of the tensors it
    made (here on the meta device, whose tensors have addresses but no
    storage); building the entry again gives a new record over the new
    tensors.  CPU entries, which the plain versions serve, carry none and
    stay key for key the reference's."""
    assert "k1_record" not in stack.entry(device="cpu")
    for packed in (False, True):
        a, b = (stack.entry(packed=packed, device="meta") for _ in range(2))
        for e in (a, b):
            rec = e["k1_record"]
            assert list(rec.rec.base) == [e["arrays"][c].data_ptr()
                                          for c in COMPONENTS]
            assert rec.rec.meta_i == e["meta_i"].data_ptr()
            held = {id(t) for t in rec.tensors}
            assert all(id(t) in held for t in e["arrays"].values())
        assert a["k1_record"] is not b["k1_record"]
    ms = MultiSiteSlabs.from_stacks({"mlp": stack, "ffn": stack})
    assert "site_records" not in ms.entry(device="cpu")
    multi = ms.entry(device="meta")
    from repro_torch.serve.stacked import multi_site_stacked_entry

    for site in ("mlp", "ffn"):
        sl = multi_site_stacked_entry(multi, site)
        assert sl["k1_record"] is multi["site_records"][site]
        assert list(sl["k1_record"].rec.base) == [
            sl["arrays"][c].data_ptr() for c in COMPONENTS]
        assert sl["k1_record"].rec.meta_f_ld == 4


def test_site_plan_entries_carry_records(luts):
    """``SitePlan.entry`` in every form: per-plan entries carry the plan's
    record (K2, K3's per-plan route), the stacked form the stack's."""
    from repro_torch.serve.plans import SitePlan

    sp = SitePlan(site="mlp", act="silu", luts=luts, n_sites=len(luts),
                  per_layer=True)
    lay = sp.entry(form="layers", packed=True, device="meta")
    for lut, e in zip(luts, lay["layers"]):
        rec = e["k1_record"].rec
        assert list(rec.base) == [e["arrays"][c].data_ptr()
                                  for c in COMPONENTS]
        assert (rec.l, rec.w_lb, rec.w_hb) == (lut.plan.l, lut.plan.w_lb,
                                               lut.plan.w_hb)
    st = sp.entry(form="stacked", packed=True, device="meta")["stacked"]
    assert st["k1_record"].rec.n_layers == len(luts)
    assert "k1_record" not in sp.entry(form="layers", device="cpu")[
        "layers"][0]


def test_k3_takes_the_entry_record(stack, luts):
    from repro_torch.kernels.fused_matmul_lut import lut_record

    packed = stack.entry(packed=True, device="meta")
    rec, layer = lut_record({"stacked": packed, "layer": 2})
    assert rec is packed["k1_record"] and layer == 2
    multi = MultiSiteSlabs.from_stacks({"mlp": stack, "ffn": stack}).entry(
        device="meta")
    rec, layer = lut_record({"multi_entry": multi, "site": "ffn",
                             "layer": 1})
    assert rec is multi["site_records"]["ffn"] and layer == 1
    pa = luts[1].plan_arrays(packed=True, device="cpu")
    ptab = {"meta": dict(luts[1].meta(), pack=pa.pack), "arrays": pa.arrays}
    rec, layer = lut_record(ptab)            # made by hand: built per call
    assert layer == 0 and rec.rec.w_lb == luts[1].plan.w_lb
    ptab["k1_record"] = rec
    assert lut_record(ptab)[0] is rec
    with pytest.raises(ValueError):
        lut_record({"stacked": stack.entry(device="cpu"), "layer": 0})
    with pytest.raises(ValueError):
        lut_record({"multi_entry": {k: v for k, v in multi.items()
                                    if k != "site_records"},
                    "site": "mlp", "layer": 0})


def test_k1_off_the_cpu_needs_the_entry_record(stack):
    """Off the CPU, K1 only reads the entry's record: an entry without one
    is refused before anything is launched."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="launch record"):
        ops.lut_act_stacked(x, stack.entry(device="cpu"), 0)


def test_record_refuses_rows_it_cannot_point_at(stack):
    entry = dict(stack.entry(device="cpu"))
    entry["arrays"] = dict(entry["arrays"])
    entry["arrays"]["t_ust"] = entry["arrays"]["t_ust"].long()
    with pytest.raises(ValueError):
        stacked_record(entry)
    entry = dict(stack.entry(device="cpu"))
    entry["meta_i"] = entry["meta_i"].t().contiguous().t()   # strided rows
    with pytest.raises(ValueError):
        stacked_record(entry)


def test_fast_divmod_equals_floor_division(stack):
    """Every codes-per-word value 1..32, every index up to the largest
    packed row of the engine's stacks x codes per word + 1 (and past it),
    plus the top of the index range."""
    _, pack = stack.packed_arrays()
    entry = stack.entry(packed=True, device="cpu")
    top = max(entry["arrays"][c].shape[1] * pack[c]["per_word"] + 1
              for c in COMPONENTS)
    idx = np.concatenate([np.arange(max(top, 1 << 16) + 1),
                          (1 << 31) - 1 - np.arange(4096)]).astype(np.uint64)
    for d in range(1, 33):
        mul, shift = fast_divmod(d)
        assert 0 < mul < 1 << 32
        q = (((idx * np.uint64(mul)) >> np.uint64(32)) + idx) >> np.uint64(
            shift)
        np.testing.assert_array_equal(q, idx // np.uint64(d))
        np.testing.assert_array_equal(idx - q * np.uint64(d),
                                      idx % np.uint64(d))
    with pytest.raises(ValueError):
        fast_divmod(33)


# ---------------------------------------------------------------------------
# the grid, walked as the kernel walks it
# ---------------------------------------------------------------------------
def _walk(rows, cols, ld, x_addr, y_addr, es, plan):
    """Times each element of the ``(rows, cols)`` view is evaluated, and
    whether every 16-byte access lies on a 16-byte boundary."""
    threads, gx, gy, vec = plan
    count = np.zeros((rows, cols), np.int64)
    aligned = True
    step = gx * threads
    for by in range(gy):
        for r in range(by, rows, gy):
            xr = x_addr + r * ld * es
            yr = y_addr + r * cols * es
            head = min(((16 - xr % 16) % 16) // es, cols) if vec > 1 else 0
            nv = (cols - head) // vec if vec > 1 else 0
            units = nv + cols - nv * vec
            ks = np.concatenate([np.arange(bx * threads, units, step)[:, None]
                                 + np.arange(threads)[None, :]
                                 for bx in range(gx)], axis=None)
            ks = ks[ks < units]
            vk = ks[ks < nv]
            e = head + vk * vec
            for i in range(vec):
                np.add.at(count[r], e + i, 1)
            aligned &= bool(np.all((xr + e * es) % 16 == 0))
            sk = ks[ks >= nv] - nv
            se = np.where(sk < head, sk, head + nv * vec + (sk - head))
            np.add.at(count[r], se, 1)
    return count, aligned


WALKS = [  # (label, rows, cols, ld, x byte offset, dtype)
    ("decode gate view", 4, F, 2 * F, 0, torch.bfloat16),
    ("prefill gate view", 256, F, 2 * F, 0, torch.bfloat16),
    ("decode up view", 4, F, 2 * F, 2 * F, torch.bfloat16),
    ("decode contiguous", 1, 4 * F, 4 * F, 0, torch.bfloat16),
    ("prefill contiguous", 1, 256 * F, 256 * F, 0, torch.bfloat16),
    ("prefill contiguous f32", 1, 256 * F, 256 * F, 0, torch.float32),
    ("misaligned start", 1, 8003, 8003, 2, torch.bfloat16),
    ("misaligned start f32", 1, 8003, 8003, 4, torch.float32),
    ("odd row stride", 5, 37, 41, 0, torch.float32),
    ("count 1", 1, 1, 1, 0, torch.bfloat16),
    ("count 7", 1, 7, 7, 6, torch.bfloat16),
    ("count 8k + 3", 1, 8 * 1000 + 3, 8 * 1000 + 3, 0, torch.bfloat16),
]


@pytest.mark.parametrize("label,rows,cols,ld,off,dtype", WALKS,
                         ids=[w[0] for w in WALKS])
def test_k1_plan_covers_every_element_once(label, rows, cols, ld, off,
                                           dtype):
    es = dtype.itemsize
    x_addr, y_addr = (1 << 20) + off, 1 << 24
    aligned = x_addr % 16 == 0 and (rows == 1 or ld * es % 16 == 0)
    plan = k1_plan(rows, cols, dtype, sm_count=SMS, aligned=aligned)
    threads, gx, gy, vec = plan
    assert vec in (1, 16 // es)
    assert gx * gy <= SMS * K1_BLOCKS_PER_SM and gy <= 65535
    count, vec_aligned = _walk(rows, cols, ld, x_addr, y_addr, es, plan)
    assert (count == 1).all(), label
    assert vec_aligned, label


def test_k1_plan_spreads_decode_and_vectorizes_prefill():
    """Decode (4 x 3072): one element a thread, 96 blocks; prefill
    (256 x 3072, or one contiguous row): 16 bytes a thread, 768 blocks
    (one wave of resident blocks)."""
    assert k1_plan(4, F, torch.bfloat16, sm_count=SMS) == (128, 24, 4, 1)
    assert k1_plan(256, F, torch.bfloat16, sm_count=SMS) == (128, 3, 256, 8)
    assert k1_plan(1, 256 * F, torch.bfloat16, sm_count=SMS) == (128, 768,
                                                                 1, 8)


def test_view_of_gate_half_is_not_copied():
    x = torch.randn(4, 1, 2 * F).to(torch.bfloat16)
    gate, up = x.chunk(2, dim=-1)
    for half in (gate, up):
        assert k1_view(half) == (4, F, 2 * F)
    assert k1_view(x) == (1, x.numel(), x.numel())
    assert k1_view(x.transpose(0, 2)) is None     # column stride 1 lost
    assert k1_view(x[::2, :, :F]) == (2, F, 4 * F)
    assert k1_view(x.view(2, 2, 2 * F)[:, :, :F].transpose(0, 1)) is None


@pytest.mark.parametrize("form", ["raw", "packed", "multi-slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_on_gate_view_equals_contiguous_copy(stack, form, dtype):
    entry = _entries(stack)[form]
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(4, 3, 2 * 1000, generator=gen) * 3).to(dtype)
    gate = x.chunk(2, dim=-1)[0]
    assert not gate.is_contiguous()
    ib = torch.int32 if dtype == torch.float32 else torch.int16
    for layer in range(stack.n_layers):
        a = lut_act_stacked_plain(gate, entry, layer)
        b = lut_act_stacked_plain(gate.contiguous(), entry, layer)
        c = ops.lut_act_stacked(gate, entry, layer)   # CPU: the plain K1
        assert a.shape == gate.shape
        assert torch.equal(a.view(ib), b.view(ib))
        assert torch.equal(c.view(ib), b.view(ib))

