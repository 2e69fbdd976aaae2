"""The port's copy of the numpy compression engine builds the reference's
plans byte for byte and reports the same totals."""
import dataclasses

import numpy as np
import pytest

from repro import core as jcore
from repro_torch import core as tcore

CASES = [(6, 4, 0.3, True), (8, 5, 0.5, True), (8, 6, 0.0, False),
         (9, 7, 0.6, True), (10, 8, 0.4, True)]


def _specs(pkg):
    return [pkg.TableSpec.random(w_in, w_out, dc, seed=i, smooth=smooth,
                                 name=f"t{i}")
            for i, (w_in, w_out, dc, smooth) in enumerate(CASES)]


def _plan_fields(plan) -> dict:
    return {f.name: getattr(plan, f.name)
            for f in dataclasses.fields(plan)}


def _assert_same_plan(a, b):
    assert type(a).__name__ == type(b).__name__
    fa, fb = _plan_fields(a), _plan_fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert va.tobytes() == vb.tobytes(), k
        else:
            assert va == vb, k
    assert a.plut_cost() == b.plut_cost()
    np.testing.assert_array_equal(a.reconstruct(), b.reconstruct())


@pytest.mark.parametrize("exiguity", [250, None], ids=["reduced", "compressed"])
def test_engine_plans_byte_identical(exiguity):
    kw = dict(exiguity=exiguity, m_candidates=(8, 16, 32),
              lb_candidates=(0, 1, 2))
    rj = jcore.compress_network_report(_specs(jcore),
                                       jcore.CompressConfig(**kw), workers=1)
    rt = tcore.compress_network_report(_specs(tcore),
                                       tcore.CompressConfig(**kw), workers=1)
    for a, b in zip(rj.plans, rt.plans):
        _assert_same_plan(a, b)
    assert rj.total_cost == rt.total_cost
    assert rj.total_plain_cost == rt.total_plain_cost
    assert (rj.n_unique, rj.dedup_hits) == (rt.n_unique, rt.dedup_hits)
    assert [t.cost for t in rj.tables] == [t.cost for t in rt.tables]


def test_dedupe_and_activation_tables_match():
    """Duplicate activation tables dedupe the same way in both engines."""
    from repro.nn.lut_act import activation_table as j_table
    from repro_torch.nn.lut_act import activation_table as t_table

    calib = np.random.default_rng(0).normal(size=30000) * 3
    specs_j = [j_table("silu", calib, name=f"L{i}")[0] for i in range(3)]
    specs_t = [t_table("silu", calib, name=f"L{i}")[0] for i in range(3)]
    cfg = dict(exiguity=250, m_candidates=(8, 16, 32, 64),
               lb_candidates=(0, 1, 2, 3))
    rj = jcore.compress_network_report(specs_j, jcore.CompressConfig(**cfg))
    rt = tcore.compress_network_report(specs_t, tcore.CompressConfig(**cfg))
    assert rt.dedup_hits == rj.dedup_hits == 2
    assert rt.dedup_rate == rj.dedup_rate
    for a, b in zip(rj.plans, rt.plans):
        _assert_same_plan(a, b)


def test_single_table_flow_matches():
    spec_args = (8, 6, 0.4)
    sj = jcore.TableSpec.random(*spec_args, seed=7, smooth=True)
    st = tcore.TableSpec.random(*spec_args, seed=7, smooth=True)
    pj = jcore.compress_table(sj, jcore.CompressConfig())
    pt = tcore.compress_table(st, tcore.CompressConfig())
    _assert_same_plan(pj, pt)
    assert tcore.verify_care_exact(st, pt)
