"""Artifact I/O of the port against the JAX reference: ``ioutil``'s
checksum, calibration files (``repro-calib/v2``) and tuned plans
(``repro-tuned-plan/v1``), on the float32 smoke config of qwen3-0.6b with
the reference's parameters and calibration (CPU).

"Identical artifact" means the same JSON header and the same arrays, so
``payload_checksum`` is equal and either package loads the other's file;
not identical file bytes (``np.savez_compressed`` stamps each zip member
with the save time).  Everything here is exact: headers compare equal,
arrays byte for byte, table bytes as integers, and served greedy tokens
identically.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import ioutil as j_ioutil
from repro.calib import capture_calibration as j_capture
from repro.calib import load_calibration as j_load_calib
from repro.calib import save_calibration as j_save_calib
from repro.calib import synthetic_batches as j_batches
from repro.nn import init_params as j_init
from repro.serve import build_serving_plans as j_build
from repro.tune.artifact import load_tuned_plan as j_load_plan
from repro.tune.artifact import save_tuned_plan as j_save_plan
from repro.tune.artifact import tuned_plan_from_serving as j_freeze
from repro_torch import configs as tconfigs
from repro_torch import ioutil as t_ioutil
from repro_torch.bridge import params_from_jax
from repro_torch.calib import CalibrationSet as TCalib
from repro_torch.calib import load_calibration as t_load_calib
from repro_torch.calib import save_calibration as t_save_calib
from repro_torch.serve import build_serving_plans as t_build
from repro_torch.serve import greedy_decode
from repro_torch.tune import (
    TunedPlan,
    load_tuned_plan,
    save_tuned_plan,
    tuned_plan_from_serving,
)

ROOT = Path(__file__).resolve().parents[1]
B, T, NEW = 2, 8, 4


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
    calib_j = j_capture(pj, cj, j_batches(cj, 2, batch_size=2, seq_len=16,
                                          seed=1))
    calib_t = TCalib(masks=calib_j.masks, w_in=calib_j.w_in,
                     x_lo=calib_j.x_lo, x_hi=calib_j.x_hi,
                     hists=calib_j.hists, ranges=calib_j.ranges,
                     meta=calib_j.meta)
    return cj, ct, pj, pt, calib_j, calib_t


@pytest.fixture(scope="module")
def plans(setup):
    """Per-site plans of both packages from one calibration, for each
    backend (the reference's name, the port's)."""
    cj, ct, _, _, calib_j, calib_t = setup
    return {bt: (j_build(cj, calib_j, backend=bj),
                 t_build(ct, calib_t, backend=bt))
            for bj, bt in (("gather", "gather"), ("pallas", "cuda"))}


def _raw(path):
    """``(header, arrays)`` of an artifact, read by the reference."""
    return j_ioutil.load_checked_npz(path)


def _assert_same_artifact(a, b):
    (ha, da), (hb, db) = _raw(a), _raw(b)
    assert ha == hb
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape
        assert da[k].tobytes() == db[k].tobytes(), k


def test_payload_checksum_equals_reference():
    rng = np.random.default_rng(0)
    payload = {"mask:L0/mlp": rng.random(256) < 0.5,
               "hist:L0/mlp": rng.integers(0, 9, 256),
               "range:L0/mlp": rng.normal(size=2),
               "plan:mlp:0:t_ust": rng.integers(-5, 5, 128, dtype=np.int32),
               "empty": np.zeros((0, 3), np.float32),
               t_ioutil.HEADER_KEY: np.zeros(3, np.uint8)}
    assert (t_ioutil.payload_checksum(payload)
            == j_ioutil.payload_checksum(payload))
    flipped = dict(payload, **{"plan:mlp:0:t_ust": payload[
        "plan:mlp:0:t_ust"] ^ 1})
    assert (t_ioutil.payload_checksum(flipped)
            != t_ioutil.payload_checksum(payload))


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_calibration_loads_in_the_other_package(setup, tmp_path, saver):
    _, _, _, _, calib_j, calib_t = setup
    pj_path = j_save_calib(str(tmp_path / "ref"), calib_j)
    pt_path = t_save_calib(str(tmp_path / "port"), calib_t)
    _assert_same_artifact(pj_path, pt_path)
    path = pj_path if saver == "reference" else pt_path
    loaded = (t_load_calib if saver == "reference" else j_load_calib)(path)
    for f in ("w_in", "x_lo", "x_hi", "meta"):
        assert getattr(loaded, f) == getattr(calib_j, f), f
    for f in ("masks", "hists", "ranges"):
        got, want = getattr(loaded, f), getattr(calib_j, f)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (f, k)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
def test_tuned_plan_loads_in_the_other_package(setup, plans, tmp_path,
                                               backend):
    """The frozen plans of the two packages are one artifact; each loads
    the other's, ``"pallas"`` read as the port's ``"cuda"``."""
    cj, ct, *_ = setup
    pj, pt = plans[backend]
    ref = j_save_plan(str(tmp_path / "ref"), j_freeze(cj, pj))
    mine = save_tuned_plan(str(tmp_path / "port"),
                           tuned_plan_from_serving(ct, pt))
    _assert_same_artifact(ref, mine)
    want = {"gather": "gather", "cuda": "pallas"}[backend]
    assert _raw(mine)[0]["backend"] == want
    tp = load_tuned_plan(ref)
    assert tp.backend == backend
    jp = j_load_plan(mine)
    assert jp.backend == want
    for got in (tp, jp):
        assert (got.arch, got.n_layers, got.per_layer, got.meta) == (
            ct.name, ct.n_layers, {"mlp": True}, jp.meta)
        assert sorted(got.sites) == sorted(pj.sites)
    for site, entries in tp.sites.items():
        for e, f in zip(entries, jp.sites[site]):
            assert e["meta"] == f["meta"]
            for c in f["arrays"]:
                assert e["arrays"][c].tobytes() == f["arrays"][c].tobytes()


@pytest.mark.parametrize("which", ["calibration", "tuned plan"])
@pytest.mark.parametrize("damage", ["truncated", "bit-flipped"])
def test_damaged_artifact_raises_naming_the_path(setup, plans, tmp_path,
                                                 which, damage):
    _, ct, _, _, _, calib_t = setup
    if which == "calibration":
        path = t_save_calib(str(tmp_path / "a"), calib_t)
        load = t_load_calib
    else:
        path = save_tuned_plan(str(tmp_path / "a"), tuned_plan_from_serving(
            ct, plans["gather"][1]))
        load = load_tuned_plan
    raw = bytearray(Path(path).read_bytes())
    if damage == "truncated":
        raw = raw[:len(raw) * 3 // 5]
    else:
        # 16 bits in the back three quarters, as the reference's
        # serve/faults.py::corrupt_file flips them
        rng = np.random.default_rng(0)
        for _ in range(16):
            raw[int(rng.integers(len(raw) // 4, len(raw)))] ^= \
                1 << int(rng.integers(8))
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(t_ioutil.ArtifactError, match=str(path)):
        load(path)


def test_unknown_stored_backend_raises(setup, plans, tmp_path):
    ct = setup[1]
    tp = tuned_plan_from_serving(ct, plans["gather"][1])
    path = save_tuned_plan(str(tmp_path / "a"), tp)
    header, arrays = t_ioutil.load_checked_npz(path)
    header.pop("checksum")
    t_ioutil.save_checked_npz(path, dict(header, backend="tpu"), arrays)
    with pytest.raises(t_ioutil.ArtifactError, match="backend 'tpu'"):
        load_tuned_plan(path)
    with pytest.raises(ValueError, match="unknown backend"):
        save_tuned_plan(str(tmp_path / "b"),
                        dataclasses.replace(tp, backend="pallas"))


@pytest.mark.parametrize("form", ["stacked", "unrolled", "fused"])
def test_reference_saved_plan_serves_the_in_process_tokens(
        setup, plans, tmp_path, form):
    """A tuned plan saved by the reference, loaded by the port and served
    on the gather backend on the CPU: the tokens of the port's in-process
    plans, in every exec form, and its tables byte-equal to theirs."""
    cj, ct, _, pt, *_ = setup
    pj, plans_t = plans["cuda"]
    tp = load_tuned_plan(j_save_plan(str(tmp_path / "ref"),
                                     j_freeze(cj, pj)))
    exec_ = "unrolled" if form == "unrolled" else "stacked"
    kw = dict(backend="gather", plan_exec=exec_, device="cpu",
              kernel="fused" if form == "fused" else None)
    loaded, built = tp.tables_for_model(**kw), plans_t.tables_for_model(**kw)
    _assert_tables_equal(loaded, built)
    cfg = dataclasses.replace(tp.patched_config(ct),
                              lut_fuse=form == "fused")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        1, ct.vocab_size, (B, T)))
    assert (greedy_decode(cfg, pt, tokens, NEW, lut_tables=loaded)
            == greedy_decode(cfg, pt, tokens, NEW, lut_tables=built))
    packed = tp.tables_for_model(backend="cuda", plan_exec=exec_,
                                 device="cpu")
    _assert_tables_equal(packed, plans_t.tables_for_model(
        backend="cuda", plan_exec=exec_, device="cpu"))


def _assert_tables_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tables_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tables_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("exec_", ["stacked", "unrolled"])
@pytest.mark.parametrize("backend", ["gather", "cuda"])
def test_table_bytes_equal_reference(plans, exec_, backend):
    pj, pt = plans[backend]
    bj = {"gather": "gather", "cuda": "pallas"}[backend]
    assert pt.table_bytes(plan_exec=exec_, backend=backend) == \
        pj.table_bytes(plan_exec=exec_, backend=bj)


def test_tuned_plan_refuses_another_arch(setup, plans):
    tp = tuned_plan_from_serving(setup[1], plans["gather"][1])
    assert isinstance(tp, TunedPlan)
    assert tp.meta["cost"] == plans["gather"][1].total_cost > 0
    other = tconfigs.smoke_config(tconfigs.get_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="tuned for arch"):
        tp.patched_config(other)
    with pytest.raises(ValueError, match="plan_exec"):
        tp.tables_for_model(plan_exec="scan", device="cpu")


def _launch(*argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-0.6b", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3", *argv],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return next(l for l in r.stdout.splitlines()
                if l.startswith("request 0:")), r.stdout


def test_launcher_saves_and_serves_artifacts(tmp_path):
    """``--calib-path`` saves then reloads the calibration, ``--save-plan``
    freezes the plans, ``--tuned-plan`` serves them: the same tokens each
    time."""
    calib, plan = str(tmp_path / "calib"), str(tmp_path / "plan")
    first, out = _launch("--lut-act", "--calib-steps", "1", "--calib-path",
                         calib, "--save-plan", plan)
    assert "saved calibration" in out and "saved tuned plan" in out
    again, out = _launch("--lut-act", "--calib-path", calib)
    assert "loaded calibration" in out and again == first
    served, out = _launch("--tuned-plan", plan)
    assert "no recapture/recompression" in out and served == first
    int8, out = _launch("--lut-act", "--calib-path", calib, "--kv-int8")
    assert "prefill replay" in out


@pytest.mark.parametrize("argv,msg", [
    (["--tuned-plan", "no-such-plan"], "--tuned-plan: no artifact at"),
    (["--save-plan", "x"], "--save-plan needs --lut-act plans"),
])
def test_launcher_artifact_errors(argv, msg):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-0.6b", *argv], env=env, capture_output=True,
        text=True, timeout=240, cwd=ROOT)
    assert r.returncode == 2 and msg in r.stderr


def test_reference_loads_port_calibration_into_identical_plans(setup,
                                                                tmp_path):
    """A port-saved calibration builds, in the reference, the plans the
    reference builds from its own capture."""
    cj, _, _, _, calib_j, calib_t = setup
    loaded = j_load_calib(t_save_calib(str(tmp_path / "c"), calib_t))
    a = j_build(cj, loaded).tables_for_model(mesh=False)
    b = j_build(cj, calib_j).tables_for_model(mesh=False)
    flat_a, flat_b = (jax.tree.leaves(to_np(t)) for t in (a, b))
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, np.ndarray):
            assert x.tobytes() == np.asarray(y).tobytes()
        else:
            assert x == y
    assert json.dumps(loaded.meta) == json.dumps(calib_j.meta)
