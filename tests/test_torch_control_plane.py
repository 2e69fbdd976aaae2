"""The port's serving control plane on the CPU: fault injection, the
gated hot reload and the per-site backend degradation ladder, driving
the :class:`~repro_torch.serve.batching.ContinuousBatcher` on the smoke
config of qwen3-0.6b.

The reference's chaos cases (``tests/test_robust_serve.py``, its
``robust`` marker, which tier-1 leaves out) but its three
``test_timeline_*`` ones, which read the telemetry log and are in
``tests/test_torch_obs_serve.py``, with its invariants: no request is ever dropped; a reload
rejected by the parity gate or by artifact integrity never serves a
token; demotion above the float rung changes no served token; demoted
sites come back once the fault clears; a fault inside the probation
window rolls back to the previous plan and schedules a bounded retry.

The CPU runs no kernel, so where a case needs a kernel rung the ladder's
top rung is ``gather`` and the fault is armed at ``gather:lut_act``: a
demoted site then serves the exact activation (the float rung), which
the cases hold against a run with no tables.  A plan cut over onto the
``cuda`` backend cannot launch its kernels on a CPU tensor and raises at
its first step: the probation cases use that real fault.  The kernel
fault drill itself (``cuda:lut_act_multi`` demoting ``cuda_fused`` to
``cuda`` and back, and a corrupted super-slab caught by revalidation) is
``chip_smoke.py`` phase 19.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.ioutil import (
    ArtifactError,
    load_checked_npz,
    save_checked_npz,
)
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.nn import init_params
from repro_torch.nn.mlp import apply_lut_act, site_tables
from repro_torch.serve import ContinuousBatcher, Request, build_serving_plans
from repro_torch.serve.degrade import (
    RUNGS,
    CompositeSupervisor,
    DegradationLadder,
)
from repro_torch.serve.faults import (
    FaultInjector,
    corrupt_file,
    corrupt_tables,
    fault_point,
)
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


@pytest.fixture(scope="module")
def model():
    cfg = smoke_config(get_config("qwen3-0.6b"))
    return cfg, init_params(cfg, device="cpu")


@pytest.fixture(scope="module")
def plans(model):
    """Serving plans (shared synthetic calibration) and the patched
    config; backend and rung variants are rebuilt per test."""
    cfg, _ = model
    rng = np.random.default_rng(0)
    p = build_serving_plans(cfg, rng.normal(size=50000) * 3,
                            backend="gather", plan_exec="stacked")
    return p, p.patched_config(cfg)


@pytest.fixture(scope="module")
def plan_path(tmp_path_factory, plans):
    """A frozen tuned-plan artifact of the active plans: its hot reload
    passes the parity gate trivially (token-identical by construction)."""
    p, cfg2 = plans
    path = str(tmp_path_factory.mktemp("plans") / "plan.npz")
    return save_tuned_plan(path, tuned_plan_from_serving(cfg2, p))


def _ladder(p, **kw):
    return DegradationLadder(p, plan_exec="stacked", device="cpu", **kw)


def _mk(model, plans, *, sup=None, lut="gather", seed=9, max_new=8,
        n_req=3, batch_size=2):
    """A loaded batcher: more requests than slots, staggered admission."""
    _, params = model
    p, cfg2 = plans
    if isinstance(lut, str):
        lut = p.tables_for_model(backend=lut, device="cpu")
    r = np.random.default_rng(seed)
    b = ContinuousBatcher(cfg2, params, batch_size=batch_size,
                          max_seq=24, eos_token=-1, lut_tables=lut,
                          prefill="replay", supervisor=sup)
    for i in range(n_req):
        b.submit(Request(rid=i,
                         prompt=[int(x) for x in
                                 r.integers(1, cfg2.vocab_size, 6)],
                         max_new=max_new))
    return b


def _toks(reqs):
    return {r.rid: r.out for r in reqs}


def _reloader(bat, cfg, params, **kw):
    kw.setdefault("backend", "gather")
    return PlanReloader(bat, cfg, params, plan_exec="stacked", **kw)


# ---------------------------------------------------------------------------
# artifact integrity
# ---------------------------------------------------------------------------
def test_checked_npz_roundtrip_and_corruption(tmp_path):
    path = str(tmp_path / "art.npz")
    payload = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
               "b": np.linspace(0, 1, 7, dtype=np.float32)}
    save_checked_npz(path, {"format": "x/v1"}, payload, kind="unit")
    header, arrays = load_checked_npz(path, kind="unit")
    assert header["format"] == "x/v1" and "checksum" in header
    assert np.array_equal(arrays["a"], payload["a"])
    for mode in ("truncate", "bitflip"):
        bad = corrupt_file(path, str(tmp_path / f"bad_{mode}.npz"),
                           mode=mode)
        with pytest.raises(ArtifactError, match=os.path.basename(bad)):
            load_checked_npz(bad, kind="unit")
    with pytest.raises(ValueError, match="unknown mode"):
        corrupt_file(path, str(tmp_path / "x.npz"), mode="melt")


def test_calibration_artifact_corruption_rejected(tmp_path, model):
    from repro_torch.calib import (capture_calibration, load_calibration,
                                   save_calibration, synthetic_batches)

    cfg, params = model
    calib = capture_calibration(params, cfg,
                                synthetic_batches(cfg, 1, batch_size=1,
                                                  seq_len=8, seed=3))
    path = save_calibration(str(tmp_path / "calib"), calib)
    assert load_calibration(path).summary() == calib.summary()
    bad = corrupt_file(path, str(tmp_path / "calib_bad.npz"),
                       mode="bitflip")
    with pytest.raises((ArtifactError, ValueError), match="calib_bad"):
        load_calibration(bad)


def test_tuned_plan_checksum_catches_bitflip(tmp_path, plan_path):
    bad = corrupt_file(plan_path, str(tmp_path / "plan_bad.npz"),
                       mode="bitflip")
    with pytest.raises(ArtifactError, match="plan_bad"):
        load_tuned_plan(bad)


# ---------------------------------------------------------------------------
# gated hot reload
# ---------------------------------------------------------------------------
def test_hot_reload_mid_decode_token_identity(model, plans, plan_path):
    """A gated cutover mid-decode drops no request and changes no served
    token (the frozen plan is the active plan, bit for bit)."""
    _, params = model
    _, cfg2 = plans
    ref = _toks(_mk(model, plans).run())
    bat = _mk(model, plans)
    rel = _reloader(bat, cfg2, params)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(plan_path, 3)
    done = bat.run()
    assert rel.counters["reloads_ok"] == 1, rel.records
    assert rel.records[-1].ok and rel.records[-1].stage == "cutover"
    assert rel.records[-1].token_agreement == 1.0
    assert bat.table_swaps == 1
    assert _toks(done) == ref
    m = bat.metrics()
    assert m["dropped"] == 0 and m["finished"] == 3


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corrupt_artifact_reload_rejected(tmp_path, model, plans,
                                          plan_path, mode):
    _, params = model
    _, cfg2 = plans
    bad = corrupt_file(plan_path, str(tmp_path / f"p_{mode}.npz"),
                       mode=mode)
    bat = _mk(model, plans, seed=13)
    rel = _reloader(bat, cfg2, params)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(bad, 2)
    done = bat.run()
    rec = rel.records[-1]
    assert not rec.ok and rec.stage == "load"
    assert os.path.basename(bad) in rec.reason
    assert bat.table_swaps == 0
    assert bat.metrics()["dropped"] == 0 and len(done) == 3


def test_missing_artifact_reload_rejected(model, plans):
    _, params = model
    _, cfg2 = plans
    bat = _mk(model, plans, seed=13, max_new=4)
    rel = _reloader(bat, cfg2, params)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule("/nonexistent/plan.npz", 1)
    bat.run()
    rec = rel.records[-1]
    assert not rec.ok and rec.stage == "load"
    assert rel.counters["rejected_load"] == 1 and bat.table_swaps == 0


def test_wrong_arch_artifact_rejected(model, plans, plan_path):
    _, params = model
    bat = _mk(model, plans, max_new=4)
    other = smoke_config(get_config("phi4-mini-3.8b"))
    rel = _reloader(bat, other, params)
    rec = rel.reload(plan_path)
    assert not rec.ok and rec.stage == "load"
    assert "qwen3-0.6b" in rec.reason and bat.table_swaps == 0


def test_garbage_plan_rejected_by_parity_gate(tmp_path, model, plans,
                                              plan_path):
    """A structurally valid artifact with garbage *values* (checksum
    fine, dequantization range shifted) is caught by the parity gate."""
    _, params = model
    _, cfg2 = plans
    tp = load_tuned_plan(plan_path)
    for entries in tp.sites.values():
        for e in entries:
            e["meta"] = dict(e["meta"], y_lo=e["meta"]["y_lo"] + 10.0,
                             y_hi=e["meta"]["y_hi"] + 10.0)
    garbage = save_tuned_plan(str(tmp_path / "garbage.npz"), tp)
    load_tuned_plan(garbage)   # integrity passes: values are the problem
    bat = _mk(model, plans)
    rel = _reloader(bat, cfg2, params)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(garbage, 2)
    done = bat.run()
    rec = rel.records[-1]
    assert not rec.ok and rec.stage == "gate", rec
    assert "parity gate failed" in rec.reason
    assert rec.top1_drop > 0.01
    assert rel.counters["rejected_gate"] == 1
    assert bat.table_swaps == 0
    assert _toks(done) == _toks(_mk(model, plans).run())


def test_slow_reload_times_out(model, plans, plan_path):
    _, params = model
    _, cfg2 = plans
    bat = _mk(model, plans, max_new=4)
    rel = _reloader(bat, cfg2, params, timeout_s=0.05)
    with FaultInjector() as fi:
        fi.inject("reload:load", exc=None, delay=0.2)   # slow, not dead
        rec = rel.reload(plan_path)
    assert fi.log == [("reload:load", 1)]
    assert not rec.ok and rec.stage == "timeout"
    assert "timeout" in rec.reason and bat.table_swaps == 0
    assert rel.counters["rejected_timeout"] == 1


def test_watch_mode_reloads_on_mtime_change(tmp_path, model, plans,
                                            plan_path):
    _, params = model
    _, cfg2 = plans
    path = str(tmp_path / "watched.npz")
    with open(plan_path, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    bat = _mk(model, plans)
    rel = _reloader(bat, cfg2, params)

    class Toucher:   # the retune pipeline dropping a fresh artifact
        def on_tick(self, b):
            if b.steps == 3:
                os.utime(path, (time.time() + 5, time.time() + 5))

    bat.supervisor = CompositeSupervisor(Toucher(), rel)
    rel.watch(path)
    done = bat.run()
    assert rel.counters["reloads_ok"] == 1, rel.records
    assert _toks(done) == _toks(_mk(model, plans).run())


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------
def test_gather_fault_demotes_to_float_exact_activation(model, plans):
    """A persistent fault of the top rung's evaluator demotes the site to
    the float rung, which serves the exact activation: the tokens are a
    run with no tables."""
    ref = _toks(_mk(model, plans, lut=None).run())
    p, _ = plans
    lad = _ladder(p, top_rung="gather")
    with FaultInjector() as fi:
        fi.inject("gather:lut_act", message="injected evaluator fault")
        bat = _mk(model, plans, sup=CompositeSupervisor(lad),
                  lut=lad.tables())
        done = bat.run()
    assert lad.status() == {"mlp": "float"} and lad.demotions == 1
    assert lad.faults[0][:2] == ("mlp", "gather")
    assert "injected evaluator fault" in lad.faults[0][2]
    assert lad.tables() is None
    assert _toks(done) == ref
    assert bat.metrics()["dropped"] == 0


def test_transient_fault_repromotes_after_backoff(model, plans):
    p, _ = plans
    lad = _ladder(p, top_rung="gather", backoff_ticks=2)
    with FaultInjector() as fi:
        fi.inject("gather:lut_act", times=2, message="transient")
        bat = _mk(model, plans, sup=CompositeSupervisor(lad),
                  lut=lad.tables())
        done = bat.run()
    assert lad.status() == {"mlp": "gather"}
    assert lad.demotions == 1 and lad.promotions == 1
    assert lad.health["mlp"].last_fault == "RuntimeError: transient"
    assert all(len(r.out) == 8 for r in done)
    assert bat.metrics()["dropped"] == 0
    assert bat.table_swaps == 2     # the demotion and the promotion


def test_kernel_rung_that_cannot_launch_demotes_to_gather(model, plans):
    """On the CPU the cuda rung cannot launch its kernels (a tensor off
    the card): the ladder demotes the site to gather at the first fault,
    and the tokens equal a gather-only run."""
    ref = _toks(_mk(model, plans, lut="gather").run())
    p, _ = plans
    lad = _ladder(p, top_rung="cuda")
    assert lad.status() == {"mlp": "cuda"}
    assert lad.tables()["sites"]["mlp"]["backend"] == "cuda"
    bat = _mk(model, plans, sup=CompositeSupervisor(lad), lut=lad.tables())
    done = bat.run()
    assert lad.status() == {"mlp": "gather"} and lad.demotions == 1
    assert "card" in lad.health["mlp"].last_fault
    assert _toks(done) == ref
    assert bat.metrics()["dropped"] == 0


def test_ladder_rungs_and_default_top(plans, model):
    cfg, params = model
    p, _ = plans
    assert RUNGS == ("cuda_fused", "cuda", "gather", "float")
    # shared tables have no per-layer site: no fused form
    assert not p.fused_available()
    assert _ladder(p).status() == {"mlp": "cuda"}
    from repro_torch.calib import capture_calibration, synthetic_batches

    calib = capture_calibration(params, cfg, synthetic_batches(
        cfg, 1, batch_size=2, seq_len=8, seed=1))
    per_layer = build_serving_plans(cfg, calib)
    assert per_layer.fused_available()
    lad = _ladder(per_layer)
    assert lad.status() == {"mlp": "cuda_fused"}
    tabs = lad.tables()
    assert tabs["kernel"] == "fused" and "multi" in tabs
    assert tabs["sites"]["mlp"] == {"multi": "mlp", "backend": "cuda"}
    # a rebind keeps a lower configured top rung
    g = _ladder(per_layer, top_rung="gather")
    g.rebind(per_layer)
    assert g.status() == {"mlp": "gather"}
    with pytest.raises(ValueError, match="unknown ladder rung"):
        _ladder(p, top_rung="pallas")


def test_corrupt_tables_change_values_not_shapes(plans):
    p, _ = plans
    tables = p.tables_for_model(backend="gather", device="cpu")
    bad = corrupt_tables(tables, "mlp")
    assert bad["sites"]["mlp"] is not tables["sites"]["mlp"]
    x = torch.linspace(-4, 4, 256)
    good_y = apply_lut_act(x, site_tables(tables, "mlp"), "gather")
    bad_y = apply_lut_act(x, site_tables(bad, "mlp"), "gather")
    assert good_y.shape == bad_y.shape and not torch.equal(good_y, bad_y)
    a, b = tables["sites"]["mlp"]["arrays"], bad["sites"]["mlp"]["arrays"]
    assert all(a[c].shape == b[c].shape and a[c].dtype == b[c].dtype
               for c in a)
    # the source's memoized entry is untouched
    again = p.tables_for_model(backend="gather", device="cpu")
    assert torch.equal(apply_lut_act(x, site_tables(again, "mlp"),
                                     "gather"), good_y)


# ---------------------------------------------------------------------------
# the per-site backend key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scope", ["act", "all"])
def test_per_site_backend_key_wins_over_top_level(model, scope):
    """Every site entry marked ``gather`` under a top-level ``cuda``: the
    forward runs on the CPU (where ``cuda`` raises) and gives the gather
    tables' tokens, for the MLP site and, in scope ``all``, exp, rsqrt,
    rope and the matmul-epilogue form."""
    from repro_torch.calib import capture_calibration, synthetic_batches
    from repro_torch.tune import greedy_tokens

    cfg, params = model
    cfg = dataclasses.replace(cfg, lut_sites=scope,
                              lut_fuse=scope == "all")
    calib = capture_calibration(params, cfg, synthetic_batches(
        cfg, 1, batch_size=2, seq_len=8, seed=1))
    p = build_serving_plans(cfg, calib)
    gather = p.tables_for_model(backend="gather", device="cpu")
    mixed = dict(gather, backend="cuda",
                 sites={k: dict(e, backend="gather")
                        for k, e in gather["sites"].items()})
    batch = {"tokens": np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 6)).astype(np.int32)}
    cfg2 = p.patched_config(cfg)
    assert greedy_tokens(cfg2, params, batch, 3, mixed) == greedy_tokens(
        cfg2, params, batch, 3, gather)
    with pytest.raises(ValueError, match="card"):
        greedy_tokens(cfg2, params, batch, 3, dict(gather, backend="cuda",
                                                   sites=gather["sites"]))


def test_kernel_wrappers_are_fault_points():
    """The wrappers consult the injectors at their entry, before choosing
    the plain version for a CPU tensor; with no injector entered, nothing
    fires."""
    p = build_serving_plans(smoke_config(get_config("qwen3-0.6b")),
                            np.linspace(-3, 3, 4096))
    st = p.sites["mlp"].stacked().entry(packed=True, device="cpu")
    x = torch.zeros(8)
    ops.lut_act_stacked(x, st, 0)
    with FaultInjector() as fi:
        fi.inject("cuda:lut_act_stacked", times=1)
        with pytest.raises(RuntimeError,
                           match="injected fault at cuda:lut_act_stacked"):
            ops.lut_act_stacked(x, st, 0)
        ops.lut_act_stacked(x, st, 0)      # the one firing is spent
        fi.inject("cuda:lut_reconstruct", exc=ValueError, after=1)
        pa = ops.PlanArrays.from_plan(p.sites["mlp"].lut.plan,
                                      device="cpu")
        ops.lut_reconstruct(torch.zeros(4, dtype=torch.int32), pa)
        with pytest.raises(ValueError):
            ops.lut_reconstruct(torch.zeros(4, dtype=torch.int32), pa)
    assert fi.log == [("cuda:lut_act_stacked", 1),
                      ("cuda:lut_reconstruct", 2)]
    fault_point("cuda:lut_act_stacked")    # no injector entered: no-op


# ---------------------------------------------------------------------------
# probation rollback
# ---------------------------------------------------------------------------
def test_post_cutover_fault_rolls_back(model, plans, plan_path):
    """The gate passes on gather values, but the artifact served on the
    cuda backend faults at its first step (no kernel can launch on the
    CPU): probation rolls back to the previous gather plan, the run ends
    token-identical to it, and nothing is dropped."""
    _, params = model
    _, cfg2 = plans
    ref = _toks(_mk(model, plans).run())
    bat = _mk(model, plans)
    rel = _reloader(bat, cfg2, params, backend="cuda", max_retries=0,
                    probation_ticks=8)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(plan_path, 2)
    done = bat.run()
    assert rel.counters["reloads_ok"] == 1
    assert rel.counters["rollbacks"] == 1
    assert rel.records[-1].stage == "rollback"
    assert "card" in rel.records[-1].reason
    assert _toks(done) == ref
    assert bat.metrics()["dropped"] == 0


def test_rollback_schedules_bounded_retry(model, plans, plan_path):
    _, params = model
    _, cfg2 = plans
    bat = _mk(model, plans, max_new=16)
    rel = _reloader(bat, cfg2, params, backend="cuda", max_retries=1,
                    probation_ticks=4, retry_backoff_ticks=2)
    bat.supervisor = CompositeSupervisor(rel)
    rel.schedule(plan_path, 2)
    done = bat.run()
    assert rel.counters["reloads_ok"] == 2       # original + retry cutover
    assert rel.counters["rollbacks"] == 2        # both rolled back
    assert rel.counters["retries_scheduled"] == 1
    assert rel._pending is None                  # budget exhausted
    assert all(len(r.out) == 16 for r in done)
    assert bat.metrics()["dropped"] == 0


# ---------------------------------------------------------------------------
# combined chaos
# ---------------------------------------------------------------------------
def test_combined_faults_drop_nothing(tmp_path, model, plans, plan_path):
    """A corrupt reload attempt, then a good reload, plus a transient
    evaluator fault: reloader and ladder chained, nothing dropped."""
    _, params = model
    _, cfg2 = plans
    p, _ = plans
    bad = corrupt_file(plan_path, str(tmp_path / "chaos.npz"),
                       mode="truncate")
    lad = _ladder(p, top_rung="gather", backoff_ticks=2)
    bat = _mk(model, plans, lut=lad.tables(), max_new=12)
    rel = _reloader(bat, cfg2, params, ladder=lad)
    rel.schedule(bad, 2)       # rejected at load

    class Second:              # then a good reload later in the run
        fired = False

        def on_tick(self, b):
            if b.steps == 6 and not self.fired:
                self.fired = True
                rel.schedule(plan_path, 6)

    bat.supervisor = CompositeSupervisor(Second(), rel, lad)
    with FaultInjector() as fi:
        fi.inject("gather:lut_act", times=2, after=1, message="flaky")
        done = bat.run()
    m = bat.metrics()
    assert m["dropped"] == 0 and m["finished"] == 3
    assert all(len(r.out) == 12 for r in done)
    assert rel.counters["rejected_load"] == 1
    assert rel.counters["reloads_ok"] >= 1
    assert lad.source is not p           # rebound to the reloaded plan
    assert lad.status() == {"mlp": "gather"}


# ---------------------------------------------------------------------------
# the launcher's control-plane flags
# ---------------------------------------------------------------------------
def _serve(argv):
    return launcher.main(["--device", "cpu", "--arch", "qwen3-0.6b",
                          "--lut-act", "--calib-steps", "1",
                          "--new-tokens", "6"] + argv)


def test_launcher_reload_degrade_and_slo(tmp_path, capsys):
    frozen = str(tmp_path / "frozen.npz")
    plain = _serve(["--save-plan", frozen])
    out = _serve(["--reload-plan", frozen, "--degrade", "--slo-ms", "1e6",
                  "--reload-gate-tokens", "2", "--reload-max-drop", "0"])
    text = capsys.readouterr().out
    assert out["reloader"].counters["reloads_ok"] == 1
    assert out["ladder"].status() == {"mlp": "gather"}
    assert out["metrics"]["dropped"] == 0
    assert out["metrics"]["slo_tracked"] == 4
    assert out["metrics"]["slo_violations"] == 0
    assert "degradation ladder attached, top rung gather" in text
    assert "cut over at tick 3" in text
    # the batcher's tokens equal the launcher's lock-step decode
    got = {r.rid: r.out for r in out["finished"]}
    assert [got[i] for i in range(4)] == plain["tokens"]


def test_launcher_watch_and_rejected_reload_exit(tmp_path, capsys):
    frozen = str(tmp_path / "frozen.npz")
    _serve(["--save-plan", frozen])
    out = _serve(["--reload-plan", frozen, "--watch"])
    assert out["reloader"].counters["reloads_ok"] == 0   # never touched
    tp = load_tuned_plan(frozen)
    for entries in tp.sites.values():
        for e in entries:
            e["meta"] = dict(e["meta"], y_lo=e["meta"]["y_lo"] + 10.0,
                             y_hi=e["meta"]["y_hi"] + 10.0)
    garbage = save_tuned_plan(str(tmp_path / "garbage.npz"), tp)
    with pytest.raises(SystemExit) as info:
        _serve(["--reload-plan", garbage])
    assert info.value.code == 1
    # an error line goes to stderr, as the reference's log.error sends it
    assert "never cut over" in capsys.readouterr().err


def test_launcher_reload_refuses_a_family_the_batcher_refuses(tmp_path):
    with pytest.raises(SystemExit) as info:
        launcher.main(["--device", "cpu", "--arch", "rwkv6-3b",
                       "--reload-plan", str(tmp_path / "none.npz")])
    assert info.value.code == 2
