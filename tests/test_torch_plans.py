"""Calibration capture, serving plans and the launcher of the port against
the JAX reference (float32 smoke config of qwen3-0.6b, CPU)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.calib import CalibrationSet as JCalib
from repro.calib import calibration_from_capture as j_from_capture
from repro.calib import capture_model as j_capture_model
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.calib import CalibrationSet as TCalib
from repro_torch.calib import calibration_from_capture as t_from_capture
from repro_torch.calib import capture_model as t_capture_model
from repro_torch.calib import synthetic_batches as t_batches
from repro_torch.launch import serve as serve_launcher
from repro_torch.serve import build_serving_plans as t_build

ROOT = Path(__file__).resolve().parents[1]
# The two forwards sum in other orders, so an activation within ~1e-6 of
# a histogram bin edge may be binned one bin over: per key, at most 1% of
# the samples may move (measured: none or a handful of 4096).
HIST_MOVE_FRAC = 0.01


def to_np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a) if isinstance(a, jax.Array) else a, tree)


@pytest.fixture(scope="module")
def setup():
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(to_np(pj), ct, device="cpu")
    cap_j = j_capture_model(pj, cj, j_batches(cj, 2, batch_size=2,
                                              seq_len=16, seed=1))
    return cj, ct, pj, pt, cap_j


def test_synthetic_batches_equal_reference(setup):
    cj, ct, *_ = setup
    for a, b in zip(j_batches(cj, 3, 2, 16, seed=5),
                    t_batches(ct, 3, 2, 16, seed=5)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_capture_matches_reference(setup):
    cj, ct, pj, pt, cap_j = setup
    cap_t = t_capture_model(pt, ct, t_batches(ct, 2, batch_size=2,
                                              seq_len=16, seed=1))
    assert sorted(cap_t.hists) == sorted(cap_j.hists) == ["L0/mlp",
                                                          "L1/mlp"]
    assert (cap_t.n_samples, cap_t.n_batches) == (cap_j.n_samples,
                                                  cap_j.n_batches)
    for key, hj in cap_j.hists.items():
        ht = cap_t.hists[key]
        assert ht.sum() == hj.sum()
        moved = np.abs(ht - hj).sum() / 2
        assert moved <= HIST_MOVE_FRAC * hj.sum(), (key, moved)
        np.testing.assert_allclose(cap_t.ranges[key], cap_j.ranges[key],
                                   rtol=1e-5)
    calib_t = t_from_capture(cap_t, min_count=1, smoothing=1)
    calib_j = j_from_capture(cap_j, min_count=1, smoothing=1)
    assert calib_t.sites() == calib_j.sites()
    assert calib_t.w_in == calib_j.w_in


@pytest.mark.parametrize("smoothing", [0, 2])
def test_plans_from_reference_histograms_are_byte_equal(setup, smoothing):
    """A CalibrationSet built from the reference's histograms goes through
    both ``build_serving_plans``: same tables, cost and dedupe rate."""
    cj, ct, _, _, cap_j = setup
    calib_j = j_from_capture(cap_j, smoothing=smoothing)
    calib_t = TCalib(masks=calib_j.masks, w_in=calib_j.w_in,
                     x_lo=calib_j.x_lo, x_hi=calib_j.x_hi,
                     hists=calib_j.hists, ranges=calib_j.ranges)
    assert isinstance(calib_j, JCalib)
    pj, pt = j_build(cj, calib_j), t_build(ct, calib_t)
    assert pj.total_cost == pt.total_cost
    assert pj.report.dedup_rate == pt.report.dedup_rate
    assert pj.report.total_cost == pt.report.total_cost
    for exec_ in ("stacked", "unrolled"):
        for backend_j, backend_t in (("gather", "gather"),
                                     ("pallas", "cuda")):
            tj = to_np(pj.tables_for_model(backend=backend_j,
                                           plan_exec=exec_, mesh=False))
            tt = pt.tables_for_model(backend=backend_t, plan_exec=exec_,
                                     device="cpu")
            _assert_tables_equal(tj["sites"], tt["sites"])
    tj = to_np(pj.tables_for_model(backend="pallas", kernel="fused",
                                   mesh=False))
    tt = pt.tables_for_model(backend="cuda", kernel="fused", device="cpu")
    _assert_tables_equal(tj["multi"], tt["multi"])


def test_shared_plans_byte_equal(setup):
    cj, ct, *_ = setup
    calib = np.random.default_rng(0).normal(size=100000) * 3
    pj, pt = j_build(cj, calib), t_build(ct, calib)
    assert pj.total_cost == pt.total_cost
    assert pj.report.dedup_rate == pt.report.dedup_rate == 0.5
    _assert_tables_equal(
        to_np(pj.tables_for_model(backend="pallas", mesh=False))["sites"],
        pt.tables_for_model(backend="cuda", device="cpu")["sites"])


def _assert_tables_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tables_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tables_equal(x, y)
    elif isinstance(a, np.ndarray):
        y = b.numpy()
        assert a.dtype == y.dtype and a.shape == y.shape
        assert a.tobytes() == y.tobytes()
    else:
        assert a == b


def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)


def test_launcher_serves_on_cpu_with_gather():
    r = _launch("--device", "cpu", "--arch", "qwen3-0.6b", "--lut-act",
                "--calib-steps", "1", "--lut-backend", "gather", "--batch",
                "2", "--prompt-len", "8", "--new-tokens", "3")
    assert r.returncode == 0, r.stderr
    assert "per-layer tables" in r.stdout
    line = next(l for l in r.stdout.splitlines()
                if l.startswith("request 0:"))
    assert len(eval(line.split(":", 1)[1])) == 3


def test_launcher_cuda_backend_on_cpu_exits_with_a_clear_error():
    r = _launch("--device", "cpu", "--arch", "qwen3-0.6b", "--lut-act",
                "--lut-backend", "cuda")
    assert r.returncode == 2
    assert "--lut-backend cuda" in r.stderr and "--device cuda" in r.stderr


@pytest.mark.parametrize("argv, want", [
    ([], "cuda"), (["--device", "cuda:0"], "cuda"),
    (["--device", "cpu"], "gather"),
    (["--device", "cpu", "--lut-backend", "gather"], "gather"),
    (["--lut-backend", "gather"], "gather")])
def test_launcher_backend_follows_the_device(argv, want):
    """Unnamed, the backend is the device's own: the kernels on the card
    (the default device), the plain form under ``--device cpu``."""
    assert serve_launcher.parse_args(argv).lut_backend == want
