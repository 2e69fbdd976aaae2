"""The port's telemetry on the served path, on the CPU: the drift monitor
through the continuous batcher (sampled, in both prefill modes) against
the reference's batcher, in-distribution and out-of-distribution drift,
token identity with telemetry on, the ``--lut-fuse`` monitored route, the
step's op list with telemetry off, the control plane's timeline (the
reference's three ``test_timeline_*`` cases of
``tests/test_robust_serve.py``) and the launcher's ``--obs-log``.

The model is the float32 smoke config of qwen3-0.6b (2 layers, d_model
64) with the reference's parameters carried across by
``bridge.params_from_jax``; where both batchers serve, their monitors use
the same calibration masks.  Per-key ``lookups`` are held equal to the
reference's (they count elements, so they depend only on the traffic and
the sampling); ``hits`` are held only within the port (the two
frameworks' float32 matmuls differ in the last bits, which can move a
pre-activation across a bin edge).

On the CPU the ladder's top rung is ``gather`` with the fault at
``gather:lut_act`` (a demoted site serves the exact activation), and a
plan cut over onto the ``cuda`` backend cannot launch its kernels on a
CPU tensor: the probation case uses that real fault.  The kernel drill
(``cuda:lut_act_multi``) and the CUDA graphs are ``chip_smoke.py`` phase
20.
"""
import contextlib
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import obs as jobs
from repro.calib import CalibrationSet as JCalibrationSet
from repro.calib import capture_calibration as j_capture
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve.batching import ContinuousBatcher as JBatcher
from repro.serve.batching import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.bridge import params_from_jax, tables_from_jax
from repro_torch.calib import (
    CalibrationSet,
    capture_calibration,
    load_calibration,
    synthetic_batches,
)
from repro_torch.launch import serve as launcher
from repro_torch.launch.obs import main as obs_main
from repro_torch.nn.transformer import decoder_forward
from repro_torch.serve import (
    CapturedStep,
    ContinuousBatcher,
    Request,
    build_serving_plans,
    decode_step,
    init_cache,
    prefill,
)
from repro_torch.serve.degrade import CompositeSupervisor, DegradationLadder
from repro_torch.serve.faults import FaultInjector, corrupt_file
from repro_torch.serve.reload import PlanReloader
from repro_torch.tune import (
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_serving,
)


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


@pytest.fixture(scope="module")
def model():
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def calib(model):
    """The reference's per-site calibration (w_in 8) as both packages'
    CalibrationSet, the same masks."""
    cj, _, pj, _ = model
    c = j_capture(pj, cj, j_batches(cj, 2, batch_size=2, seq_len=8,
                                    seed=1), w_in=8)
    fields = dict(masks=dict(c.masks), w_in=c.w_in, x_lo=c.x_lo,
                  x_hi=c.x_hi, hists=dict(c.hists))
    return JCalibrationSet(**fields), CalibrationSet(**fields)


@pytest.fixture(scope="module")
def served(model):
    """The port's own calibration and gather plans of the smoke model:
    ``(patched cfg, params, plans, calibration)``."""
    _, ct, _, pt = model
    c = capture_calibration(pt, ct, synthetic_batches(ct, 2, batch_size=2,
                                                      seq_len=8, seed=1),
                            w_in=8)
    plans = build_serving_plans(ct, c, w_out=8, backend="gather")
    return plans.patched_config(ct), pt, plans, c


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, vocab, 5 + i))) for i in range(3)]


def _run_batcher(cls, req_cls, cfg, params, prompts, monitor, prefill_mode,
                 tables=None):
    b = cls(cfg, params, batch_size=2, max_seq=32, eos_token=-1,
            prefill=prefill_mode, lut_tables=tables)
    for i, p in enumerate(prompts):
        b.submit(req_cls(rid=i, prompt=list(p), max_new=6))
    with monitor if monitor is not None else contextlib.nullcontext():
        done = b.run()
    return {r.rid: list(r.out) for r in done}


# =========================================================================
# the batcher under a sampled monitor
# =========================================================================
@pytest.fixture(scope="module")
def ref_tables(model, calib):
    """The reference's stacked gather tables (w_in 8, w_out 8) from the
    shared calibration, as both packages' tables and patched configs."""
    from repro.serve import build_serving_plans as j_build

    cj, ct, _, _ = model
    jcal, _ = calib
    plans = j_build(cj, jcal, w_out=8)
    tj = plans.tables_for_model(backend="gather", mesh=False)
    return (tj, tables_from_jax(to_np(tj), device="cpu"),
            plans.patched_config(cj),
            dataclasses.replace(ct, lut_activation=True))


@pytest.mark.parametrize("tables", ["none", "stacked"])
@pytest.mark.parametrize("prefill_mode", ["step", "replay"])
def test_batcher_sampled_drift_monitoring(model, calib, ref_tables,
                                          prefill_mode, tables):
    """The monitored step on every ``sample_every``-th tick only (and on
    every replayed prompt token): tokens equal the unmonitored run at
    sample_every 1 and 3, the sampled monitor sees a strict subset of the
    traffic, and the lookups equal the reference batcher's.  With stacked
    tables the keys are per layer on both sides and equal key for key;
    with none served the reference's layer scan passes no layer id, so it
    counts every layer under the bare ``mlp`` key (the union row), where
    the port's eager loop names each layer: the totals are equal."""
    cj, ct, pj, pt = model
    jcal, tcal = calib
    if tables == "stacked":
        tj, tt, cj, ct = ref_tables
    else:
        tj = tt = None
    prompts = _prompts(ct.vocab_size)
    base = _run_batcher(ContinuousBatcher, Request, ct, pt, prompts, None,
                        prefill_mode, tt)
    lookups = {}
    for every in (1, 3):
        mon = obs.DontCareMonitor(tcal, sample_every=every, device="cpu")
        assert _run_batcher(ContinuousBatcher, Request, ct, pt, prompts,
                            mon, prefill_mode, tt) == base
        jmon = jobs.DontCareMonitor(jcal, sample_every=every)
        _run_batcher(JBatcher, JRequest, cj, pj, prompts, jmon,
                     prefill_mode, tj)
        jmon.flush()
        if tables == "stacked":
            assert mon.lookups == dict(jmon.lookups), every
        else:
            assert set(jmon.lookups) == {"mlp"}
            assert set(mon.lookups) == {f"L{i}/mlp"
                                        for i in range(ct.n_layers)}
        assert sum(mon.lookups.values()) == sum(jmon.lookups.values())
        lookups[every] = sum(mon.lookups.values())
    assert lookups[1] > 0 and 0 < lookups[3] < lookups[1]


def test_batcher_monitor_with_served_tables(served):
    """With gather tables: tokens equal, every layer's key is counted, and
    each counts whole step calls (B rows x d_ff each)."""
    cfg, params, plans, c = served
    tables = plans.tables_for_model(backend="gather", device="cpu")
    prompts = _prompts(cfg.vocab_size)
    base = _run_batcher(ContinuousBatcher, Request, cfg, params, prompts,
                        None, "step", tables)
    mon = obs.DontCareMonitor(c, sample_every=2, device="cpu")
    b = ContinuousBatcher(cfg, params, batch_size=2, max_seq=32,
                          eos_token=-1, lut_tables=tables)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=list(p), max_new=6))
    with mon:
        done = {r.rid: list(r.out) for r in b.run()}
    assert done == base
    per_layer = {k: v for k, v in mon.lookups.items()}
    assert set(per_layer) == {f"L{i}/mlp" for i in range(cfg.n_layers)}
    assert len(set(per_layer.values())) == 1
    assert next(iter(per_layer.values())) % (2 * cfg.d_ff) == 0


# =========================================================================
# drift: in distribution 0, out of distribution > 0
# =========================================================================
def _served_hits(cfg, params, c, batches):
    mon = obs.DontCareMonitor(c, device="cpu")
    with mon, torch.no_grad():
        for batch in batches:
            decoder_forward(params, cfg, torch.as_tensor(
                np.asarray(batch["tokens"]), dtype=torch.long))
    rows = mon.drift()
    assert rows, "monitor observed no lookups"
    return (sum(r["dontcare_hits"] for r in rows.values()),
            sum(r["lookups"] for r in rows.values()))


def test_drift_in_distribution_vs_ood(served):
    """Replaying the calibration traffic through the same forward reports
    exactly zero don't-care hits (every observed bin is care at
    min_count=1, and the monitor's codes are the capture's), while traffic
    the calibration never saw lands in rewritten bins."""
    cfg, params, _, c = served
    hits, n = _served_hits(cfg, params, c, synthetic_batches(
        cfg, 2, batch_size=2, seq_len=8, seed=1))
    assert hits == 0 and n == 2 * 2 * 8 * cfg.d_ff * cfg.n_layers
    ood, _ = _served_hits(cfg, params, c, synthetic_batches(
        cfg, 2, batch_size=2, seq_len=8, seed=9))
    assert ood > 0


# =========================================================================
# token identity, the fused route, the op list
# =========================================================================
def _decode(cfg, params, tables, n_new=3, seed=7):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 5)))
    logits, cache = prefill(params, cfg, {"tokens": toks}, max_seq=5 + n_new,
                            lut_tables=tables)
    tok = logits[:, -1].argmax(-1)[:, None]
    out = []
    for i in range(n_new):
        out.append(tok[:, 0].tolist())
        logits, cache = decode_step(params, cfg, cache, tok, 5 + i, tables)
        tok = logits[:, -1].argmax(-1)[:, None]
    return out


@pytest.mark.parametrize("fuse", [False, True])
def test_token_identity_under_telemetry(served, fuse):
    """Serving with the event log and the monitor on gives the tokens of
    serving with them off; under ``--lut-fuse`` the monitored route (the
    fused GEMM alone, the monitor, the LUT) counts the same lookups and
    hits as the unfused step, whose pre-activation has the same bits."""
    cfg, params, plans, c = served
    tables = plans.tables_for_model(backend="gather", device="cpu")
    fcfg = dataclasses.replace(cfg, lut_fuse=fuse)
    plain = _decode(fcfg, params, tables)
    counts = {}
    for f, cf in ((fuse, fcfg), (False, cfg)):
        tel = obs.Telemetry(events=obs.EventLog(),
                            monitor=obs.DontCareMonitor(c, device="cpu"))
        with tel:
            assert _decode(cf, params, tables) == plain
            counts[f] = tel.monitor.counts()
        assert any(r["event"] == "drift" for r in tel.events.records)
    assert counts[fuse] == counts[False]
    assert sum(v[1] for v in counts[False].values()) > 0


def _aten_ops(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("aten::")]


@pytest.mark.parametrize("fuse", [False, True])
def test_no_telemetry_leaves_the_step_op_list_unchanged(served, fuse):
    """The profiler's op list of one decode step is the same with nothing
    entered, with a telemetry context and no monitor, and with a monitor
    hidden by ``suppressed()``; an active monitor adds its counting ops
    once per layer."""
    cfg, params, plans, c = served
    cfg = dataclasses.replace(cfg, lut_fuse=fuse)
    tables = plans.tables_for_model(backend="gather", device="cpu")
    cache = init_cache(cfg, 2, 8, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.long)
    step = lambda: decode_step(params, cfg, cache, tok, 3, tables)
    step()
    base = _aten_ops(step)
    with obs.Telemetry(events=obs.EventLog()):
        assert _aten_ops(step) == base
    mon = obs.DontCareMonitor(c, device="cpu")
    with mon:
        with obs.suppressed():
            assert _aten_ops(step) == base
        monitored = _aten_ops(step)
    assert len(monitored) > len(base)
    extra = [op for op in monitored if op == "aten::isfinite"]
    assert len(extra) == cfg.n_layers


def test_captured_step_key_holds_the_active_monitor(served):
    """A graph captured under one monitor is captured again under another,
    or with the monitor hidden (``suppressed()``) — its counting ops are
    baked into the graph."""
    cfg, params, plans, c = served
    step = CapturedStep(params, cfg, None)
    cache = init_cache(cfg, 2, 8, device="cpu")
    tok = torch.ones((2, 1), dtype=torch.long)
    off = step._key_of(cache, tok)
    m1 = obs.DontCareMonitor(c, device="cpu")
    m2 = obs.DontCareMonitor(c, device="cpu")
    with m1:
        k1 = step._key_of(cache, tok)
        with obs.suppressed():
            assert step._key_of(cache, tok) == off
        with m2:
            k2 = step._key_of(cache, tok)
    assert len({off, k1, k2}) == 3
    with pytest.raises(ValueError, match="card"):
        step.capture(cache, tok)


def test_kernel_launch_counter_counts_gather_evaluations(served):
    cfg, params, plans, _ = served
    tables = plans.tables_for_model(backend="gather", device="cpu")
    with obs.Telemetry() as tel:
        _decode(cfg, params, tables, n_new=3)
    c = tel.registry.counter("kernel_launches_total")
    # one prefill and three decode steps, each one call per layer
    assert c.value(backend="gather", kernel="lut_act_stacked") == \
        4 * cfg.n_layers
    assert c.total() == 4 * cfg.n_layers


# =========================================================================
# the control plane's timeline (tests/test_robust_serve.py's three cases)
# =========================================================================
@pytest.fixture(scope="module")
def cp_model():
    cfg = tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b"))
    from repro_torch.nn import init_params

    return cfg, init_params(cfg, device="cpu")


@pytest.fixture(scope="module")
def cp_plans(cp_model):
    cfg, _ = cp_model
    rng = np.random.default_rng(0)
    p = build_serving_plans(cfg, rng.normal(size=50000) * 3,
                            backend="gather", plan_exec="stacked")
    return p, p.patched_config(cfg)


@pytest.fixture(scope="module")
def plan_path(tmp_path_factory, cp_plans):
    p, cfg2 = cp_plans
    path = str(tmp_path_factory.mktemp("plans") / "plan.npz")
    return save_tuned_plan(path, tuned_plan_from_serving(cfg2, p))


def _mk(cp_model, cp_plans, *, sup=None, lut="gather", max_new=8):
    _, params = cp_model
    p, cfg2 = cp_plans
    if isinstance(lut, str):
        lut = p.tables_for_model(backend=lut, device="cpu")
    r = np.random.default_rng(9)
    b = ContinuousBatcher(cfg2, params, batch_size=2, max_seq=24,
                          eos_token=-1, lut_tables=lut, prefill="replay",
                          supervisor=sup)
    for i in range(3):
        b.submit(Request(rid=i, prompt=[int(x) for x in
                                        r.integers(1, cfg2.vocab_size, 6)],
                         max_new=max_new))
    return b


def _events(tel, name):
    return [r for r in tel.events.records if r["event"] == name]


def test_timeline_records_demotion_and_repromotion(cp_model, cp_plans):
    """The transient-fault scenario's demote -> backoff -> re-promote
    cycle lands in the event timeline, in order, with rung attribution —
    and the serve_fault record precedes the demotion it caused."""
    p, _ = cp_plans
    lad = DegradationLadder(p, plan_exec="stacked", top_rung="gather",
                            backoff_ticks=2, device="cpu")
    tel = obs.Telemetry(events=obs.EventLog())
    with tel, FaultInjector() as fi:
        fi.inject("gather:lut_act", times=2, message="transient")
        bat = _mk(cp_model, cp_plans, sup=CompositeSupervisor(lad),
                  lut=lad.tables())
        bat.run()
    assert lad.demotions == 1 and lad.promotions == 1

    faults = _events(tel, "serve_fault")
    demotes = _events(tel, "ladder_demote")
    promotes = _events(tel, "ladder_promote")
    assert len(demotes) == 1 and len(promotes) == 1 and faults
    assert demotes[0]["site"] == "mlp"
    assert demotes[0]["from_rung"] == "gather"
    assert demotes[0]["to_rung"] == "float"
    assert "transient" in demotes[0]["error"]
    assert promotes[0] == {**promotes[0], "site": "mlp",
                           "from_rung": "float", "to_rung": "gather"}
    assert faults[0]["seq"] < demotes[0]["seq"] < promotes[0]["seq"]
    swaps = _events(tel, "table_swap")
    assert len(swaps) >= 2
    assert [s["backend"] for s in swaps[:2]] == ["float", "gather"]
    reg = tel.registry
    assert reg.counter("ladder_demotions_total").value(site="mlp") == 1
    assert reg.counter("ladder_promotions_total").value(site="mlp") == 1
    assert reg.counter("batcher_table_swaps_total").total() == len(swaps)
    assert reg.counter("serve_faults_total").total() == len(faults)


def test_timeline_records_reload_rejection_reasons(tmp_path, cp_model,
                                                   cp_plans, plan_path):
    """Each rejection stage — integrity (load), parity (gate), timeout —
    appears as a reload_reject event naming its stage and reason."""
    _, params = cp_model
    _, cfg2 = cp_plans
    bad = corrupt_file(plan_path, str(tmp_path / "tl_bad.npz"),
                       mode="bitflip")
    tp = load_tuned_plan(plan_path)
    for entries in tp.sites.values():
        for e in entries:
            e["meta"] = dict(e["meta"], y_lo=e["meta"]["y_lo"] + 10.0,
                             y_hi=e["meta"]["y_hi"] + 10.0)
    garbage = save_tuned_plan(str(tmp_path / "tl_garbage.npz"), tp)

    bat = _mk(cp_model, cp_plans, max_new=4)
    rel = PlanReloader(bat, cfg2, params, backend="gather",
                       plan_exec="stacked")
    rel_t = PlanReloader(bat, cfg2, params, backend="gather",
                         plan_exec="stacked", timeout_s=0.05)
    tel = obs.Telemetry(events=obs.EventLog())
    with tel:
        rel.reload(bad)
        rel.reload(garbage)
        with FaultInjector() as fi:
            fi.inject("reload:load", exc=None, delay=0.2)
            rel_t.reload(plan_path)
    attempts = _events(tel, "reload_attempt")
    rejects = _events(tel, "reload_reject")
    assert len(attempts) == 3 and len(rejects) == 3
    by_stage = {r["stage"]: r for r in rejects}
    assert set(by_stage) == {"load", "gate", "timeout"}
    assert os.path.basename(bad) in by_stage["load"]["reason"]
    assert "parity gate failed" in by_stage["gate"]["reason"]
    assert "timeout" in by_stage["timeout"]["reason"]
    assert not _events(tel, "reload_cutover")
    for stage in ("load", "gate", "timeout"):
        assert tel.registry.counter("reloads_total").value(
            stage=stage, ok="false") == 1


def test_timeline_records_cutover_rollback_and_retry(cp_model, cp_plans,
                                                     plan_path):
    """The bounded-retry scenario: both cutovers, both rollbacks (the
    ``cuda`` backend cannot launch on a CPU tensor) and the single
    scheduled retry are all on the timeline, ordered."""
    _, params = cp_model
    _, cfg2 = cp_plans
    bat = _mk(cp_model, cp_plans, max_new=16)
    rel = PlanReloader(bat, cfg2, params, backend="cuda",
                       plan_exec="stacked", max_retries=1,
                       probation_ticks=4, retry_backoff_ticks=2)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(plan_path, 2)
    tel = obs.Telemetry(events=obs.EventLog())
    with tel:
        bat.run()
    assert rel.counters["rollbacks"] == 2

    cutovers = _events(tel, "reload_cutover")
    rollbacks = _events(tel, "reload_rollback")
    retries = _events(tel, "reload_retry_scheduled")
    assert len(cutovers) == 2 and len(rollbacks) == 2 and len(retries) == 1
    for c in cutovers:
        assert c["token_agreement"] == 1.0   # frozen active plan: trivial
    for r in rollbacks:
        assert "card" in r["reason"]
    seqs = sorted((e["seq"], e["event"]) for e in
                  cutovers + rollbacks + retries)
    assert [s[1] for s in seqs] == [
        "reload_cutover", "reload_rollback", "reload_retry_scheduled",
        "reload_cutover", "reload_rollback"]
    reg = tel.registry.counter("reloads_total")
    assert reg.value(stage="cutover", ok="true") == 2
    assert reg.value(stage="rollback", ok="false") == 2


# =========================================================================
# the launcher's --obs-log and the report CLI
# =========================================================================
LAUNCH = ["--device", "cpu", "--arch", "qwen3-0.6b", "--lut-act",
          "--lut-backend", "gather", "--batch", "2", "--prompt-len", "8",
          "--new-tokens", "4"]


@pytest.mark.parametrize("extra", [[], ["--lut-fuse"]])
def test_launcher_obs_log(tmp_path, extra, capsys):
    calib = str(tmp_path / "calib.npz")
    path = str(tmp_path / "serve.jsonl")
    off = launcher.main(LAUNCH + extra + ["--calib-steps", "1",
                                          "--calib-path", calib])
    on = launcher.main(LAUNCH + extra + ["--calib-path", calib,
                                         "--obs-log", path])
    assert on["tokens"] == off["tokens"]
    recs = obs.read_events(path)
    assert jobs.read_events(path) == recs
    events = {r["event"] for r in recs}
    assert {"params", "calib_loaded", "span_begin", "compress",
            "plans_built", "prefill", "decode", "request_tokens",
            "drift", "kernel_launches", "obs_end"} <= events
    keys = set(load_calibration(calib).masks)
    drift = {r["site"]: r for r in recs if r["event"] == "drift"}
    assert set(drift) == keys
    assert all(r["lookups"] > 0 for r in drift.values())
    assert "lut_dontcare_served_frac" in open(path + ".prom").read()
    capsys.readouterr()
    assert obs_main([path]) == 0
    out = capsys.readouterr().out
    assert "== don't-care drift (served vs calibration) ==" in out


def test_launcher_reload_timeline_in_the_obs_log(tmp_path):
    frozen = str(tmp_path / "frozen")
    launcher.main(LAUNCH + ["--calib-steps", "1", "--save-plan", frozen])
    path = str(tmp_path / "reload.jsonl")
    out = launcher.main(LAUNCH + [
        "--calib-steps", "1", "--reload-plan", frozen + ".npz",
        "--degrade", "--obs-log", path, "--obs-drift-every", "2",
        "--obs-sample", "3"])
    assert out["reloader"].counters["reloads_ok"] == 1
    recs = obs.read_events(path)
    names = [r["event"] for r in recs]
    for ev in ("ladder_attached", "reload_scheduled", "reload_attempt",
               "reload_cutover", "table_swap", "tick", "request_finish",
               "serve_summary", "drift"):
        assert ev in names, ev
    assert names.index("reload_attempt") < names.index("reload_cutover")
    ticks = [r for r in recs if r["event"] == "tick"]
    # every tick is a kept record or counted as dropped on one (the
    # footer's flush record for the last drops is no tick of its own)
    assert sum((0 if r.get("final") else 1) + r.get("sampled_dropped", 0)
               for r in ticks) == out["metrics"]["ticks"]
    footer = recs[-1]["metrics"]
    assert footer["reloads_total"]['{ok="true",stage="cutover"}'] == 1
    assert footer["batcher_ticks_total"][""] == out["metrics"]["ticks"]
    assert footer["serve_request_latency_s"][""]["count"] == 2
