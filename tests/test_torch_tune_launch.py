"""The port's autotuner on its own trained model (CPU), and its launcher.

Mirrors of the reference's ``tests/test_tune.py`` on a fixture the port
trains itself (``trained_params`` on the smoke config of qwen3-0.6b, 25
steps at 4 x 16, one device: the reference's fixture builds a mesh with
explicit axes, which its train step rejects under jax 0.9, ROADMAP queue
C), with the same assertions: output ranges, calibration store, per-site
``w_out``, the plan cache, exact-zero parity on lossless tables,
``autotune`` and its degenerate points, the tuned artifact's round trip
(gather backend, stacked and unrolled; the cuda backend's is
``chip_smoke.py`` phase 19) and its arch binding; then
``trained_params`` through a checkpoint directory, and ``launch/tune
--device cpu`` at smoke scale under the strict rules.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.calib import (
    CalibrationSet,
    calibration_from_capture,
    capture_model,
    care_mask_from_hist,
    load_calibration,
    save_calibration,
    synthetic_batches,
)
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import CompressConfig, PlanCache
from repro_torch.launch import tune as tune_launcher
from repro_torch.nn import init_params
from repro_torch.nn.lut_act import activation_table
from repro_torch.serve import build_serving_plans
from repro_torch.train import latest_step
from repro_torch.tune import (
    ParityHarness,
    SweepPoint,
    autotune,
    build_point_plans,
    calibration_for,
    greedy_tokens,
    heldout_batches,
    load_tuned_plan,
    save_tuned_plan,
    trained_params,
    tuned_plan_from_outcome,
    w_out_from_ranges,
)

RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The models here are tiny: one intra-op thread runs their eager ops
    faster than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained_dense():
    cfg = smoke_config(get_config("qwen3-0.6b"))
    params, info = trained_params(cfg, train_steps=25, batch=4, seq=16,
                                  device="cpu")
    assert info["source"] == "in_process" and info["steps"] == 25
    assert info["loss_last"] < info["loss_first"]
    assert not any(p.requires_grad for p in params.parameters())
    return cfg, params


@pytest.fixture(scope="module")
def dense_capture(trained_dense):
    cfg, params = trained_dense
    return capture_model(
        params, cfg, synthetic_batches(cfg, 2, batch_size=2, seq_len=8,
                                       seed=1))


@pytest.fixture(scope="module")
def eval_batches(trained_dense):
    cfg, _ = trained_dense
    return heldout_batches(cfg, 2, batch_size=2, seq_len=12)


# =========================================================================
# calibration groundwork
# =========================================================================
def test_capture_tracks_output_ranges(dense_capture):
    ranges = dense_capture.observed_ranges()
    assert set(ranges) == set(dense_capture.hists)
    for key, (lo, hi) in ranges.items():
        assert np.isfinite([lo, hi]).all() and hi > lo
        # silu's global minimum is about -0.2785 (bf16 rounding may land
        # a hair below it)
        assert lo >= -0.30


def test_calibration_set_carries_ranges(dense_capture):
    calib = calibration_from_capture(dense_capture)
    assert calib.ranges is not None
    assert set(calib.ranges) == set(calib.masks)
    np.testing.assert_allclose(calib.range_for("mlp", 0),
                               dense_capture.observed_ranges()["L0/mlp"])


def test_store_roundtrip_ranges_bitexact(tmp_path, dense_capture):
    calib = calibration_from_capture(dense_capture)
    loaded = load_calibration(save_calibration(str(tmp_path / "c"), calib))
    assert set(loaded.ranges) == set(calib.ranges)
    for key in calib.ranges:
        np.testing.assert_array_equal(loaded.ranges[key],
                                      calib.ranges[key])


def test_store_loads_v1_artifact_without_ranges(tmp_path):
    header = {"format": "repro-calib/v1", "w_in": 4, "x_lo": -8.0,
              "x_hi": 8.0, "meta": {}}
    path = str(tmp_path / "old.npz")
    np.savez(
        path,
        __header__=np.frombuffer(json.dumps(header).encode(), np.uint8),
        **{"mask:mlp": np.ones(16, bool)})
    loaded = load_calibration(path)
    assert loaded.ranges is None
    assert loaded.w_in == 4 and set(loaded.masks) == {"mlp"}


def test_care_mask_rejects_zero_care_bins():
    hist = np.zeros(32, np.int64)
    hist[3] = 1
    with pytest.raises(ValueError, match="zero care bins"):
        care_mask_from_hist(hist, min_count=5)


# =========================================================================
# degenerate quantizer / width hardening
# =========================================================================
def test_activation_table_rejects_unrepresentable_w_out():
    care = np.zeros(256, bool)
    care[20:24] = True
    with pytest.raises(ValueError, match="cannot represent"):
        activation_table("gelu", care=care, w_in=8, w_out=8)
    with pytest.raises(ValueError, match="fewer than two output"):
        activation_table("silu", w_in=8, w_out=1)


def test_build_serving_plans_rejects_degenerate_sweep_point():
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              activation="gelu")
    care = np.zeros(256, bool)
    care[20:24] = True
    calib = CalibrationSet(
        masks={f"L{i}/mlp": care for i in range(cfg.n_layers)}, w_in=8)
    with pytest.raises(ValueError, match="cannot represent"):
        build_serving_plans(cfg, calib, w_out=8)


def test_per_site_w_out_dict(dense_capture, trained_dense):
    cfg, _ = trained_dense
    calib = calibration_for(dense_capture, SweepPoint(), w_in=8)
    plans = build_serving_plans(cfg, calib, w_out={"mlp": 6})
    entry = plans.tables_for_model(device="cpu")["sites"]["mlp"]
    assert entry["stacked"]["meta"]["w_out"] == 6
    with pytest.raises(ValueError, match="no entry for"):
        build_serving_plans(cfg, calib, w_out={"ffn": 6})
    with pytest.raises(ValueError, match="per-site CalibrationSet"):
        build_serving_plans(cfg, RNG.normal(size=1000), w_in=8,
                            w_out={"mlp": 6})


def test_w_out_from_ranges_narrow_range_saves_bits(trained_dense,
                                                   dense_capture):
    cfg, _ = trained_dense
    calib = calibration_from_capture(dense_capture)
    w = w_out_from_ranges(cfg, calib, 10)
    assert set(w) == {"mlp"} and 4 <= w["mlp"] <= 10
    narrow = dataclasses.replace(calib)
    narrow.ranges = {k: np.array([0.0, 0.05]) for k in calib.ranges}
    assert w_out_from_ranges(cfg, narrow, 10)["mlp"] < w["mlp"]
    legacy = dataclasses.replace(calib)
    legacy.ranges = None
    assert w_out_from_ranges(cfg, legacy, 10) == {"mlp": 10}


# =========================================================================
# plan cache
# =========================================================================
def test_plan_cache_across_sweep_points(trained_dense, dense_capture):
    cfg, _ = trained_dense
    cache = PlanCache()
    p1 = build_point_plans(cfg, dense_capture, SweepPoint(w_in=8),
                           plan_cache=cache)
    assert p1.report.cache_hits == 0
    p2 = build_point_plans(cfg, dense_capture, SweepPoint(w_in=8),
                           plan_cache=cache)
    assert p2.report.cache_hits == p2.report.n_unique
    assert p2.total_cost == p1.total_cost
    for k in p1.sites:
        for a, b in zip(p1.sites[k].luts, p2.sites[k].luts):
            np.testing.assert_array_equal(a.plan.reconstruct(),
                                          b.plan.reconstruct())


# =========================================================================
# parity harness
# =========================================================================
def test_parity_lossless_compression_is_exactly_zero_drop(trained_dense,
                                                          eval_batches):
    """Full care masks: the decomposition reconstructs every entry, so
    the compressed tables measure exactly zero drop against the same
    uncompressed table."""
    cfg, params = trained_dense
    full = CalibrationSet(
        masks={f"L{i}/mlp": np.ones(256, bool)
               for i in range(cfg.n_layers)}, w_in=8)
    compressed = build_serving_plans(cfg, full, w_out=8)
    plain = build_serving_plans(
        cfg, full, w_out=8,
        compress_cfg=CompressConfig(m_candidates=(), lb_candidates=()))
    assert all(t.kind == "plain" for t in plain.report.tables)
    harness = ParityHarness(cfg, params, eval_batches,
                            ref_tables=plain.tables_for_model(device="cpu"))
    m = harness.evaluate(compressed.tables_for_model(device="cpu"))
    assert m.top1_agreement == 1.0
    assert m.kl == 0.0 and m.logit_mse == 0.0
    assert m.ppl_delta == 0.0


def test_parity_self_is_zero_and_float_baseline_sane(trained_dense,
                                                     eval_batches):
    cfg, params = trained_dense
    m = ParityHarness(cfg, params, eval_batches).evaluate(None)
    assert m.top1_agreement == 1.0 and m.kl == 0.0
    assert m.ppl_ref == m.ppl_lut > 1.0
    assert m.n_tokens == sum(np.prod(b["tokens"].shape)
                             for b in eval_batches)


# =========================================================================
# sweep + autotune + artifact round trip
# =========================================================================
@pytest.fixture(scope="module")
def tuned(trained_dense, dense_capture, eval_batches):
    cfg, params = trained_dense
    grid = [SweepPoint(), SweepPoint(coverage=0.999),
            SweepPoint(w_in=8, w_out="auto", coverage=0.999),
            SweepPoint(w_in=6, w_out=6, min_count=2)]
    return autotune(cfg, params, dense_capture, eval_batches, grid=grid,
                    budget=0.01)


def test_autotune_outcome(tuned):
    out = tuned
    assert out.results[0].point == SweepPoint()
    assert out.default.ok
    assert len(out.frontier) >= 1
    assert out.metrics.top1_drop <= 0.01 or not out.budget_met
    if out.budget_met:
        assert out.cost <= out.default.cost
    ok_costs = {r.cost for r in out.results if r.ok}
    assert all(r.cost in ok_costs for r in out.frontier)


def test_autotune_skips_degenerate_points(trained_dense, dense_capture,
                                          eval_batches):
    cfg, params = trained_dense
    out = autotune(cfg, params, dense_capture, eval_batches,
                   grid=[SweepPoint(), SweepPoint(min_count=10 ** 9)],
                   budget=0.5)
    assert out.results[1].error is not None
    assert "zero care bins" in out.results[1].error
    assert out.results[0].ok


def test_tuned_artifact_roundtrip_token_identical(tmp_path, tuned,
                                                  trained_dense):
    cfg, params = trained_dense
    tp = tuned_plan_from_outcome(cfg, tuned)
    loaded = load_tuned_plan(save_tuned_plan(str(tmp_path / "tuned"), tp))
    assert loaded.arch == cfg.name
    assert loaded.knobs.keys() == {"mlp"}
    assert loaded.meta["cost"] == tuned.cost
    batch = {"tokens": np.asarray(
        RNG.integers(1, cfg.vocab_size, (2, 6)), np.int32)}
    live = greedy_tokens(cfg, params, batch, 4,
                         lut_tables=tuned.plans.tables_for_model(
                             device="cpu"))
    for plan_exec in ("stacked", "unrolled"):
        got = greedy_tokens(cfg, params, batch, 4,
                            lut_tables=loaded.tables_for_model(
                                backend="gather", plan_exec=plan_exec,
                                device="cpu"))
        assert got == live, plan_exec
    for site, entries in tp.sites.items():
        for a, b in zip(entries, loaded.sites[site]):
            assert a["meta"] == b["meta"]
            for f in a["arrays"]:
                np.testing.assert_array_equal(a["arrays"][f],
                                              b["arrays"][f])


def test_tuned_plan_rejects_wrong_arch(tuned, trained_dense):
    cfg, _ = trained_dense
    tp = tuned_plan_from_outcome(cfg, tuned)
    with pytest.raises(ValueError, match="tuned for arch"):
        tp.patched_config(smoke_config(get_config("rwkv6-3b")))


def test_mixed_assignment_builds_per_kind_plans():
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    params = init_params(cfg, device="cpu")
    cap = capture_model(
        params, cfg, synthetic_batches(cfg, 1, batch_size=2, seq_len=8,
                                       seed=1))
    assignment = {None: SweepPoint(w_in=8),
                  "expert": SweepPoint(w_in=8, w_out=6),
                  "mlp": SweepPoint(w_in=8, w_out=8, coverage=0.999)}
    plans = build_point_plans(cfg, cap, assignment, w_in=8)
    tabs = plans.tables_for_model(device="cpu")["sites"]
    assert tabs["expert"]["stacked"]["meta"]["w_out"] == 6
    assert tabs["mlp"]["stacked"]["meta"]["w_out"] == 8


# =========================================================================
# trained_params through a checkpoint directory
# =========================================================================
def test_trained_params_checkpoints_then_restores(tmp_path):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    ckpt = str(tmp_path / "ckpt")
    p1, info1 = trained_params(cfg, ckpt_dir=ckpt, train_steps=4, batch=2,
                               seq=8, device="cpu")
    assert info1["source"] == "in_process" and latest_step(ckpt) == 3
    p2, info2 = trained_params(cfg, ckpt_dir=ckpt, device="cpu")
    assert info2 == {"source": "checkpoint", "step": 3, "ckpt_dir": ckpt}
    for (n, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        assert a.dtype == b.dtype and bool((a == b).all()), n
    other = smoke_config(get_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="does not match arch"):
        trained_params(other, ckpt_dir=ckpt, device="cpu")


# =========================================================================
# the launcher
# =========================================================================
def test_launcher_cpu_smoke_strict_round_trip(tmp_path):
    out_path, bench = str(tmp_path / "tp.npz"), str(tmp_path / "tb.json")
    argv = ["--device", "cpu", "--train-steps", "30", "--calib-steps", "2",
            "--eval-steps", "2", "--out", out_path, "--bench-out", bench]
    lines = []
    res = tune_launcher.run(tune_launcher.parse_args(argv), log=lines.append)
    assert res["failures"] == [], res["failures"]
    assert tune_launcher.main(argv) == 0
    payload = json.load(open(bench))
    assert payload["schema"] == "tune_bench/v1"
    assert payload["scale"] == "smoke" and payload["budget_met"]
    assert payload["tuned"]["cost"] < payload["default"]["cost"]
    assert len(payload["frontier"]) >= 3
    assert payload["eval_tokens"] == 2 * 2 * 16
    assert all("eval_s" in r for r in payload["sweep"])
    assert res["round_trip"]["backends"] == ("gather",)
    assert any("token-identical on gather" in m for m in lines)
    assert any("needs the card" in m for m in lines)
    assert set(res["stages"]) == {"train", "capture", "sweep",
                                  "backend_equivalence", "greedy",
                                  "round_trip"}
    tp = load_tuned_plan(out_path)
    assert tp.meta["trained"]["source"] == "in_process"
    assert tp.meta["cost"] == payload["tuned"]["cost"]


def test_launcher_strict_exit_and_no_strict(tmp_path, capsys):
    """A budget no point can meet fails the strict exit (status 1) and only
    warns under ``--no-strict``."""
    argv = ["--device", "cpu", "--train-steps", "2", "--calib-steps", "1",
            "--eval-steps", "1", "--grid", "quick", "--budget", "-1",
            "--out", str(tmp_path / "tp.npz")]
    assert tune_launcher.main(argv) == 1
    # an error line goes to stderr, as the reference's log.error sends it
    assert "FAIL: budget not met" in capsys.readouterr().err
    assert tune_launcher.main(argv + ["--no-strict"]) == 0
    assert "WARNING: budget not met" in capsys.readouterr().out


def test_launcher_cuda_backend_on_cpu_is_refused():
    with pytest.raises(SystemExit) as info:
        tune_launcher.main(["--device", "cpu", "--backend", "cuda"])
    assert info.value.code == 2
