"""The port's accuracy-parity autotuner (``repro_torch.tune``) held against
the JAX reference (``repro.tune``) on the CPU, float32 smoke configs with
the reference's parameters moved by the bridge (the reference's
``trained_params`` is never called: its mesh has explicit axes, which
its train step rejects under jax 0.9, ROADMAP queue C).

Exact: ``fold_hist`` bit for bit over random histograms and every
narrower width; ``pareto_frontier`` / ``select_by_budget`` /
``greedy_select`` on the reference's property cases (the same items
returned); ``calibration_for``'s masks bit for bit; ``w_out_from_ranges``;
every cost, plain cost, table bytes, site cost, dedup rate, cache-hit
count and error of ``run_sweep``; ``autotune``'s frontier labels,
selected point, assignment and cost; greedy tokens of all six families
(encdec against the reference's decode from its prefill cache padded to
``max_seq``, ROADMAP queue C); top-1 agreement.

Within stated tolerances: ``model_logits`` of all six families within
``LOGIT_ATOL`` of the reference's jitted forward, exact; with the same
tables every position within ``LOGIT_ATOL`` but at most
``EDGE_POSITIONS`` of them, which stay within ``LUT_EDGE_ATOL`` (the two
frameworks sum in other orders, and an activation within float32
rounding of a quantizer bin edge lands one table level away: a step of
span / 1023 of the activation, about 2e-3 on the logits here, as
``tests/test_torch_decode.py`` explains); greedy tokens identical; the
parity metrics' ``kl`` within ``KL_RTOL``, ``logit_mse`` within
``MSE_RTOL`` and the perplexities within ``PPL_RTOL`` (relative): the
port sums each position's float32 terms over the vocabulary where the
reference sums the whole batch in one numpy float32 reduction, so the
two round differently; a KL near 1e-5 is a difference of log-probs a few
ulps wide, where the two orders of summation differ at 1e-3 of it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.calib import capture_model as j_capture
from repro.calib import fold_hist as j_fold
from repro.calib import model_batch as j_model_batch
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro.tune import (
    ParityHarness as JHarness,
    SweepPoint as JPoint,
    autotune as j_autotune,
    calibration_for as j_calibration_for,
    default_grid as j_grid,
    greedy_select as j_greedy,
    greedy_tokens as j_greedy_tokens,
    heldout_batches as j_heldout,
    load_tuned_plan as j_load_plan,
    model_logits as j_logits,
    pareto_frontier as j_pareto,
    run_sweep as j_run_sweep,
    save_tuned_plan as j_save_plan,
    select_by_budget as j_select,
    tuned_plan_from_outcome as j_freeze_outcome,
    w_out_from_ranges as j_w_out,
)
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.calib import capture_model as t_capture
from repro_torch.calib import fold_hist
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.serve import build_serving_plans as t_build
from repro_torch.tune import (
    ParityHarness,
    SweepPoint,
    autotune,
    calibration_for,
    default_grid,
    greedy_select,
    greedy_tokens,
    heldout_batches,
    load_tuned_plan,
    model_logits,
    pareto_frontier,
    run_sweep,
    save_tuned_plan,
    select_by_budget,
    tuned_plan_from_outcome,
    w_out_from_ranges,
)

LOGIT_ATOL = 1e-5
LUT_EDGE_ATOL = 5e-3
EDGE_POSITIONS = 1
KL_RTOL = 1e-2
MSE_RTOL = 1e-4
PPL_RTOL = 1e-5
FAMILIES = {"dense": "qwen3-0.6b", "moe": "deepseek-moe-16b",
            "vlm": "phi-3-vision-4.2b", "ssm": "rwkv6-3b",
            "hybrid": "recurrentgemma-9b", "encdec": "whisper-small"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The models here are tiny: one intra-op thread runs their eager ops
    faster than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


def _cfgs(arch):
    cj = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)),
                             dtype="float32")
    ct = dataclasses.replace(tconfigs.smoke_config(tconfigs.get_config(arch)),
                             dtype="float32")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    return cj, ct


_MODELS = {}


def _model(arch):
    """Both packages' float32 smoke model on the reference's parameters."""
    if arch not in _MODELS:
        cj, ct = _cfgs(arch)
        pj = j_init(cj, jax.random.PRNGKey(0))
        _MODELS[arch] = (cj, ct, pj, params_from_jax(to_np(pj), ct,
                                                     device="cpu"))
    return _MODELS[arch]


@pytest.fixture(scope="module")
def dense():
    """qwen3's smoke model, one shared capture of both packages (their
    histograms equal), and the held-out batches."""
    cj, ct, pj, pt = _model("qwen3-0.6b")
    cap_j = j_capture(pj, cj, j_batches(cj, 2, batch_size=2, seq_len=8,
                                        seed=1))
    cap_t = t_capture(pt, ct, t_batches(ct, 2, batch_size=2, seq_len=8,
                                        seed=1))
    assert cap_j.hists.keys() == cap_t.hists.keys()
    for k in cap_j.hists:
        np.testing.assert_array_equal(cap_j.hists[k], cap_t.hists[k])
    batches = heldout_batches(ct, 2, batch_size=2, seq_len=12)
    return cj, ct, pj, pt, cap_j, cap_t, batches


def _jpoint(p: SweepPoint) -> JPoint:
    return JPoint(**dataclasses.asdict(p))


# =========================================================================
# pure functions
# =========================================================================
@pytest.mark.parametrize("w_from", [4, 8, 10, 12])
def test_fold_hist_bit_for_bit_every_narrower_width(w_from):
    rng = np.random.default_rng(w_from)
    for trial in range(3):
        h = rng.integers(0, 50, 1 << w_from) * (rng.random(1 << w_from)
                                                < 0.4)
        for w_to in range(1, w_from + 1):
            a, b = fold_hist(h, w_to), j_fold(h, w_to)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            assert a.sum() == h.sum()
    with pytest.raises(ValueError, match="refine"):
        fold_hist(np.zeros(1 << w_from, np.int64), w_from + 1)
    with pytest.raises(ValueError, match="power of two"):
        fold_hist(np.zeros(12, np.int64), 2)


def test_fold_hist_preserves_mass_and_grid():
    """The reference's own case."""
    h = np.zeros(1 << 10, np.int64)
    h[[0, 1, 511, 512, 1022, 1023]] = [7, 1, 3, 4, 2, 9]
    f = fold_hist(h, 8)
    assert f.size == 256 and f.sum() == h.sum()
    assert f[0] == 8 and f[255] == 11
    assert fold_hist(h, 10) is not h
    np.testing.assert_array_equal(fold_hist(h, 10), h)


# the reference's property cases (tests/test_tune.py), as cases of one test
PARETO_CASES = [(0, 1), (1, 5), (7, 40), (13, 17), (42, 3), (77, 25),
                (120, 40), (150, 9), (199, 31), (200, 2)]


@pytest.mark.parametrize("seed,n", PARETO_CASES)
def test_pareto_frontier_and_budget_pick_equal_reference(seed, n):
    rng = np.random.default_rng(seed)
    pts = [{"cost": int(rng.integers(1, 50)),
            "drop": round(float(rng.random()), 2)} for _ in range(n)]
    cost, drop = (lambda r: r["cost"]), (lambda r: r["drop"])
    front = pareto_frontier(pts, cost=cost, drop=drop)
    assert [id(p) for p in front] == [
        id(p) for p in j_pareto(pts, cost=cost, drop=drop)]
    for a, b in zip(front, front[1:]):
        assert a["cost"] <= b["cost"] and a["drop"] > b["drop"]
    for f in front:
        for p in pts:
            assert not (p["cost"] <= f["cost"] and p["drop"] <= f["drop"]
                        and (p["cost"] < f["cost"] or p["drop"] < f["drop"]))
    for budget in (0.0, 0.25, 0.5, 1.0):
        assert (select_by_budget(front, budget, drop=drop)
                is j_select(front, budget, drop=drop))


GREEDY_SEEDS = [0, 3, 11, 29, 57, 101, 150, 222, 256, 300]


@pytest.mark.parametrize("seed", GREEDY_SEEDS)
def test_greedy_select_equal_reference_and_within_budget(seed):
    rng = np.random.default_rng(seed)
    kinds = ["mlp", "expert", "ffn"][: int(rng.integers(1, 4))]
    n_cand = int(rng.integers(2, 5))
    candidates = {k: list(range(n_cand)) for k in kinds}
    costs = {(k, c): float(rng.integers(1, 100))
             for k in kinds for c in candidates[kinds[0]]}
    budget = float(rng.random() * 0.05)

    def evaluate(assignment):
        h = hash(tuple(sorted(assignment.items()))) & 0xFFFF
        return (sum(costs[(k, c)] for k, c in assignment.items()),
                (h / 0xFFFF) * 0.1)

    start = {k: 0 for k in kinds}
    if evaluate(start)[1] > budget:
        for fn in (greedy_select, j_greedy):
            with pytest.raises(ValueError, match="violates the accuracy"):
                fn(kinds, candidates, costs, evaluate, budget=budget,
                   start=start)
        return
    got = greedy_select(kinds, candidates, costs, evaluate, budget=budget,
                        start=start)
    assert got == j_greedy(kinds, candidates, costs, evaluate,
                           budget=budget, start=start)
    assignment, info = got
    final_cost, final_drop = evaluate(assignment)
    assert final_drop <= budget and final_cost <= evaluate(start)[0]
    assert info["evals"] <= 32


# =========================================================================
# model_logits and greedy tokens, all six families
# =========================================================================
def _shared_tables(cj, ct):
    sample = np.random.default_rng(5).normal(size=20000) * 3
    pj_plans = j_build(cj, sample)
    pt_plans = t_build(ct, sample)
    assert pj_plans.total_cost == pt_plans.total_cost
    return (pj_plans.tables_for_model(),
            pt_plans.tables_for_model(device="cpu"))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_logits_and_greedy_tokens_equal_reference(family):
    cj, ct, pj, pt = _model(FAMILIES[family])
    batch = j_model_batch(cj, np.random.default_rng(0), 2, 8)
    jt, tt = _shared_tables(cj, ct)
    for jtab, ttab in ((None, None), (jt, tt)):
        jcfg = dataclasses.replace(cj, lut_activation=jtab is not None)
        tcfg = dataclasses.replace(ct, lut_activation=ttab is not None)
        want = np.asarray(jax.jit(lambda p, b: j_logits(p, jcfg, b, jtab))(
            pj, batch), np.float32)
        got = model_logits(pt, tcfg, batch, ttab).float().numpy()
        assert got.shape == want.shape == (2, 8, ct.vocab_size)
        if ttab is None:
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
            continue
        per_pos = np.abs(got - want).max(-1)
        assert per_pos.max() <= LUT_EDGE_ATOL, per_pos
        assert (per_pos > LOGIT_ATOL).sum() <= EDGE_POSITIONS, per_pos
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # greedy tokens; the reference's encdec prefill drops max_seq (ROADMAP
    # queue C), so there its greedy decode runs from its prefill cache
    # padded to max_seq, as the port's prefill pads its own
    ref = _encdec_greedy if family == "encdec" else j_greedy_tokens
    for jtab, ttab in ((None, None), (jt, tt)):
        assert greedy_tokens(ct, pt, batch, 4, ttab) == ref(cj, pj, batch,
                                                           4, jtab)


def _encdec_greedy(cfg, params, batch, n_new, tables):
    """The reference's ``greedy_tokens`` for encdec, its prefill cache's
    self K/V padded with zeros to ``T + n_new`` positions."""
    import jax.numpy as jnp
    from repro.serve.decode import decode_step, prefill

    cfg = dataclasses.replace(cfg, lut_activation=tables is not None)
    dev = {k: jnp.asarray(v) for k, v in batch.items()}
    t = dev["tokens"].shape[1]
    lg, cache = jax.jit(lambda p, x: prefill(p, cfg, x, max_seq=t + n_new,
                                             lut_tables=tables))(params, dev)
    pad = t + n_new - cache["k"].shape[2]
    cache = {n: (jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                 if n in ("k", "v") else c) for n, c in cache.items()}
    step = jax.jit(lambda p, c, tk, pos: decode_step(
        p, cfg, c, tk, pos, lut_tables=tables))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    toks = []
    for i in range(n_new):
        toks.append(np.asarray(tok)[:, 0].tolist())
        lg, cache = step(params, cache, tok, jnp.asarray(t + i))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    return [[toks[i][r] for i in range(n_new)] for r in range(len(toks[0]))]


def test_heldout_batches_bit_for_bit():
    for family in ("dense", "vlm", "encdec"):
        cj, ct, _, _ = _model(FAMILIES[family])
        a, b = heldout_batches(ct, 3, 2, 8), j_heldout(cj, 3, 2, 8)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


# =========================================================================
# parity harness
# =========================================================================
def _metrics_close(got, want):
    assert got.n_tokens == want.n_tokens
    assert got.top1_agreement == want.top1_agreement
    np.testing.assert_allclose(got.kl, want.kl, rtol=KL_RTOL, atol=0)
    np.testing.assert_allclose(got.logit_mse, want.logit_mse,
                               rtol=MSE_RTOL, atol=0)
    for k in ("ppl_ref", "ppl_lut"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=PPL_RTOL, atol=0)


def test_parity_harness_equal_reference(dense):
    cj, ct, pj, pt, cap_j, cap_t, batches = dense
    jh, th = JHarness(cj, pj, batches), ParityHarness(ct, pt, batches)
    for a, b in zip(th.ref_logits, jh.ref_logits):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=LOGIT_ATOL)
    for point in (SweepPoint(), SweepPoint(w_in=6, w_out=6, min_count=2)):
        jp = j_build(cj, j_calibration_for(cap_j, _jpoint(point)),
                     w_out=point.w_out)
        tp = t_build(ct, calibration_for(cap_t, point), w_out=point.w_out)
        _metrics_close(th.evaluate(tp.tables_for_model(device="cpu")),
                       jh.evaluate(jp.tables_for_model()))
    self_t = th.evaluate(None)
    assert self_t.top1_agreement == 1.0 and self_t.kl == 0.0
    assert self_t.logit_mse == 0.0 and self_t.ppl_delta == 0.0


def test_calibration_for_and_w_out_equal_reference(dense):
    cj, ct, pj, pt, cap_j, cap_t, _ = dense
    assignments = [SweepPoint(), SweepPoint(coverage=0.999),
                   SweepPoint(min_count=2, smoothing=1, coverage=0.99,
                              w_in=6),
                   {None: SweepPoint(w_in=8), "mlp": SweepPoint(w_in=8,
                                                                min_count=3)}]
    for a in assignments:
        ja = (_jpoint(a) if isinstance(a, SweepPoint)
              else {k: _jpoint(p) for k, p in a.items()})
        ct_calib, cj_calib = calibration_for(cap_t, a), j_calibration_for(
            cap_j, ja)
        assert ct_calib.w_in == cj_calib.w_in
        assert ct_calib.masks.keys() == cj_calib.masks.keys()
        for k in ct_calib.masks:
            np.testing.assert_array_equal(ct_calib.masks[k],
                                          cj_calib.masks[k])
            np.testing.assert_array_equal(ct_calib.hists[k],
                                          cj_calib.hists[k])
        for base in (None, 8, 10):
            assert w_out_from_ranges(ct, ct_calib, base) == j_w_out(
                cj, cj_calib, base)


def _sweep_fields(r):
    return (r.point.label(), r.w_out, r.cost, r.plain_cost, r.table_bytes,
            r.site_costs, r.dedup_rate, r.cache_hits, r.error)


def test_run_sweep_quick_grid_equal_reference(dense):
    cj, ct, pj, pt, cap_j, cap_t, batches = dense
    grid = default_grid(ct, quick=True)
    assert [p.label() for p in grid] == [
        p.label() for p in j_grid(cj, quick=True)]
    assert [p.label() for p in default_grid(ct)] == [
        p.label() for p in j_grid(cj)]
    got = run_sweep(ct, cap_t, grid, ParityHarness(ct, pt, batches))
    want = j_run_sweep(cj, cap_j, j_grid(cj, quick=True),
                       JHarness(cj, pj, batches))
    assert [_sweep_fields(r) for r in got] == [
        _sweep_fields(r) for r in want]
    for a, b in zip(got, want):
        _metrics_close(a.metrics, b.metrics)


@pytest.fixture(scope="module")
def tuned_pair(dense):
    cj, ct, pj, pt, cap_j, cap_t, batches = dense
    grid = [SweepPoint(), SweepPoint(coverage=0.999),
            SweepPoint(w_in=8, w_out="auto", coverage=0.999),
            SweepPoint(w_in=6, w_out=6, min_count=2),
            SweepPoint(min_count=10 ** 9)]
    got = autotune(ct, pt, cap_t, batches, grid=grid, budget=0.05)
    want = j_autotune(cj, pj, cap_j, batches,
                      grid=[_jpoint(p) for p in grid], budget=0.05)
    return got, want


def test_autotune_equal_reference(tuned_pair):
    got, want = tuned_pair
    assert [r.point.label() for r in got.frontier] == [
        r.point.label() for r in want.frontier]
    assert ((got.selected.point.label() if got.selected else None)
            == (want.selected.point.label() if want.selected else None))
    assert ({k: p.label() for k, p in got.assignment.items()}
            == {k: p.label() for k, p in want.assignment.items()})
    assert got.cost == want.cost and got.budget_met == want.budget_met
    assert got.results[-1].error == want.results[-1].error
    assert "zero care bins" in got.results[-1].error
    assert [_sweep_fields(r) for r in got.results] == [
        _sweep_fields(r) for r in want.results]
    assert got.plans.table_bytes() == want.plans.table_bytes()
    assert got.greedy["evals"] == want.greedy["evals"]
    _metrics_close(got.metrics, want.metrics)


def test_tuned_artifacts_load_across_packages_token_identical(
        tmp_path, dense, tuned_pair):
    cj, ct, pj, pt, *_ = dense
    got, want = tuned_pair
    batch = j_model_batch(cj, np.random.default_rng(3), 2, 6)
    t_path = save_tuned_plan(str(tmp_path / "port"),
                             tuned_plan_from_outcome(ct, got))
    j_path = j_save_plan(str(tmp_path / "ref"), j_freeze_outcome(cj, want))
    live = greedy_tokens(ct, pt, batch, 4,
                         got.plans.tables_for_model(device="cpu"))
    assert live == j_greedy_tokens(cj, pj, batch, 4,
                                   want.plans.tables_for_model())
    for path in (t_path, j_path):
        tp, jp = load_tuned_plan(path), j_load_plan(path)
        assert tp.knobs == jp.knobs and tp.meta["cost"] == jp.meta["cost"]
        assert tp.backend == "gather" and jp.backend == "gather"
        assert [r["label"] for r in tp.frontier] == [
            r["label"] for r in jp.frontier]
        for plan_exec in ("stacked", "unrolled"):
            assert greedy_tokens(ct, pt, batch, 4, tp.tables_for_model(
                plan_exec=plan_exec, device="cpu")) == live
            assert j_greedy_tokens(cj, pj, batch, 4, jp.tables_for_model(
                plan_exec=plan_exec)) == live
    a, b = load_tuned_plan(t_path), load_tuned_plan(j_path)
    for site, entries in a.sites.items():
        for x, y in zip(entries, b.sites[site]):
            assert x["meta"] == y["meta"]
            for f in x["arrays"]:
                np.testing.assert_array_equal(x["arrays"][f], y["arrays"][f])


def test_tuned_plan_from_outcome_stores_cuda_as_pallas(tmp_path, dense,
                                                       tuned_pair):
    _, ct, *_ = dense
    got, _ = tuned_pair
    tp = tuned_plan_from_outcome(ct, got)
    tp.backend = "cuda"
    assert tp.fused_available() and not tp.fused_available("unrolled")
    path = save_tuned_plan(str(tmp_path / "cuda"), tp)
    assert j_load_plan(path).backend == "pallas"
    assert load_tuned_plan(path).backend == "cuda"
    assert got.plans.fused_available()
    assert not got.plans.fused_available("unrolled")


def test_per_site_w_out_dict_equal_reference(dense):
    cj, ct, _, _, cap_j, cap_t, _ = dense
    tp = t_build(ct, calibration_for(cap_t, SweepPoint(), w_in=8),
                 w_out={"mlp": 6})
    jp = j_build(cj, j_calibration_for(cap_j, JPoint(), w_in=8),
                 w_out={"mlp": 6})
    assert tp.total_cost == jp.total_cost
    entry = tp.tables_for_model(device="cpu")["sites"]["mlp"]
    assert entry["stacked"]["meta"]["w_out"] == 6
    with pytest.raises(ValueError, match="no entry for"):
        t_build(ct, calibration_for(cap_t, SweepPoint(), w_in=8),
                w_out={"ffn": 6})
    with pytest.raises(ValueError, match="unknown site"):
        t_build(ct, calibration_for(cap_t, SweepPoint(), w_in=8),
                w_out={"mlp": 6, "nope": 4})
    with pytest.raises(ValueError, match="per-site CalibrationSet"):
        t_build(ct, np.random.default_rng(0).normal(size=1000), w_in=8,
                w_out={"mlp": 6})


def test_activation_sites_equal_reference():
    from repro.serve.plans import activation_sites as j_sites

    from repro_torch.serve import activation_sites

    for arch in tconfigs.ARCH_NAMES:
        for scope in ("act", "all"):
            ct = dataclasses.replace(
                tconfigs.smoke_config(tconfigs.get_config(arch)),
                lut_sites=scope)
            cj = dataclasses.replace(
                jconfigs.smoke_config(jconfigs.get_config(arch)),
                lut_sites=scope)
            assert activation_sites(ct) == j_sites(cj), (arch, scope)


def test_parity_harness_keeps_its_baseline_on_the_parameters_device(dense):
    """The harness keeps its float32 baseline where the parameters are."""
    _, ct, _, pt, _, _, batches = dense
    h = ParityHarness(ct, pt, batches)
    assert h.device == torch.device("cpu")
    assert all(lg.device == h.device and lg.dtype == torch.float32
               for lg in h.ref_logits)
