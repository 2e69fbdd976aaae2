"""The port's host slabs are byte-identical to the reference's: packed
words, lane padding, stacked metas, and the multi-site super-slab."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import PlanArrays as JPlanArrays
from repro.kernels import packing as jpack
from repro.nn.lut_act import build_lut_activation as j_build
from repro.serve.stacked import MultiSiteSlabs as JMulti
from repro.serve.stacked import StackedPlanArrays as JStacked
from repro_torch.kernels import PlanArrays as TPlanArrays
from repro_torch.kernels import packing as tpack
from repro_torch.nn.lut_act import build_lut_activation as t_build
from repro_torch.serve.stacked import MultiSiteSlabs as TMulti
from repro_torch.serve.stacked import StackedPlanArrays as TStacked


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("width", [1, 2, 3, 5, 8, 11, 16, 20])
def test_pack_array_words_and_unpack_take(width):
    rng = np.random.default_rng(width)
    lo = -(1 << (width - 1)) if width > 1 else 0
    a = rng.integers(lo, lo + (1 << width), size=(3, 77))
    wj, mj = jpack.pack_array(a)
    wt, mt = tpack.pack_array(a)
    _same(wj, wt)
    assert mj == mt
    assert tpack.needed_width(a) == jpack.needed_width(a)
    for row in range(a.shape[0]):
        idx = torch.arange(a.shape[1])
        got = tpack.unpack_take(torch.from_numpy(wt[row]), idx,
                                width=mt["width"], offset=mt["offset"],
                                per_word=mt["per_word"])
        want = jpack.unpack_array(wj[row], dict(mj, n=a.shape[1]))
        np.testing.assert_array_equal(got.numpy(), want)


def _luts(build):
    rng = np.random.default_rng(0)
    return [build("silu", rng.normal(size=20000) * s, lb_candidates=lb)
            for s, lb in ((2, (0,)), (3, (2,)), (2.5, (0, 1, 2, 3)))]


@pytest.fixture(scope="module")
def luts():
    return _luts(j_build), _luts(t_build)


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_plan_arrays_padding_and_packing(luts, packed):
    for lj, lt in zip(*luts):
        pj = JPlanArrays.from_plan(lj.plan, packed=packed)
        pt = TPlanArrays.from_plan(lt.plan, packed=packed, device="cpu")
        assert (pj.kind, pj.l, pj.w_lb, pj.w_hb, pj.w_in, pj.w_out) == (
            pt.kind, pt.l, pt.w_lb, pt.w_hb, pt.w_in, pt.w_out)
        assert pj.pack == pt.pack
        assert list(pj.arrays) == list(pt.arrays)
        for c in pj.arrays:
            _same(pj.arrays[c], pt.arrays[c].numpy())
            assert pt.arrays[c].numel() % (1 if packed else 128) == 0


def _stacks(luts):
    lj, lt = luts
    sj = JStacked.from_entries(
        [{"meta": l.meta(), "arrays": JPlanArrays.from_plan(l.plan).arrays}
         for l in lj])
    st = TStacked.from_entries(
        [{"meta": l.meta(), "arrays": TPlanArrays.host_arrays(l.plan)[0]}
         for l in lt])
    return sj, st


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_stacked_arrays_and_metas(luts, packed):
    sj, st = _stacks(luts)
    ej, et = sj.entry(packed=packed), st.entry(packed=packed, device="cpu")
    assert ej["meta"] == et["meta"]
    for c in ej["arrays"]:
        _same(ej["arrays"][c], et["arrays"][c].numpy())
    _same(ej["meta_i"], et["meta_i"].numpy())
    _same(ej["meta_f"], et["meta_f"].numpy())
    assert sj.lens == st.lens


def test_multi_site_super_slab(luts):
    sj, st = _stacks(luts)
    mj = JMulti.from_stacks({"mlp": sj, "ffn": sj}).entry()
    mt = TMulti.from_stacks({"mlp": st, "ffn": st}).entry(device="cpu")
    for k in ("meta_i", "meta_f", "meta_q", "meta_p"):
        _same(mj[k], mt[k].numpy())
    for c in mj["arrays"]:
        _same(mj["arrays"][c], mt["arrays"][c].numpy())
    assert mj["meta"] == mt["meta"]
    from repro.serve.stacked import multi_site_stacked_entry as j_slice
    from repro_torch.serve.stacked import multi_site_stacked_entry as t_slice

    a, b = j_slice(mj, "ffn"), t_slice(mt, "ffn")
    assert a["meta"] == b["meta"]
    for k in ("meta_i", "meta_f"):
        _same(a[k], b[k].numpy())
    for c in a["arrays"]:
        _same(a["arrays"][c], b["arrays"][c].numpy())


def test_tables_nbytes_matches(luts):
    from repro.serve.stacked import tables_nbytes as j_nbytes
    from repro_torch.serve.stacked import tables_nbytes as t_nbytes

    sj, st = _stacks(luts)
    assert j_nbytes(sj.entry(packed=True)) == t_nbytes(
        st.entry(packed=True, device="cpu"))
    assert jax.tree.leaves(sj.entry())   # the reference entry has leaves
