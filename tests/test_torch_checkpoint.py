"""Checkpoints and the supervised loop of the port, on the CPU: mirrors of
the reference's runtime tests (round trip, atomic ``LATEST``, digest and
structure checks, supervisor restart and resume, straggler monitor), and
checkpoints across the two packages: a reference checkpoint restored and
trained on by the port, the port's restored by the reference, each leaf
file with the same ``(shape, dtype, crc32)`` for the same state (bf16 and
``grad_compress`` states included).

Tolerance where the port trains on from a reference checkpoint: the next
step's loss within ``1e-5`` relative of the reference's (as in
``tests/test_torch_train_step.py``); everything else is bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro.train import restore_checkpoint as j_restore
from repro.train import save_checkpoint as j_save
from repro_torch import configs as tconfigs
from repro_torch.bridge import (
    train_state_from_checkpoint,
    train_state_from_jax,
    train_state_to_checkpoint,
)
from repro_torch.data import TokenStream
from repro_torch.train import (
    StragglerMonitor,
    Supervisor,
    TrainConfig,
    init_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.checkpoint import state_leaves
from repro_torch.train.state import state_for


def _tiny_state(seed=0):
    """A small train state: a float32 and a bf16 parameter, moments, the
    counters."""
    g = torch.Generator().manual_seed(seed)
    params = torch.nn.ParameterDict({
        "w": torch.nn.Parameter(torch.randn(4, 8, generator=g)),
        "b": torch.nn.Parameter(torch.randn(8, generator=g).to(
            torch.bfloat16))})
    state = state_for(params, TrainConfig())
    state["step"] = 3
    return state


def _values(state):
    return [(p, v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for p, v in state_leaves(state)]


def _equal(a, b):
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), p
        else:
            assert x == y, p


# --------------------------------------------------------------------------
# mirrors of the reference's checkpoint and supervisor tests
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    before = _values(state)
    save_checkpoint(str(tmp_path), state, 3)
    assert latest_step(str(tmp_path)) == 3
    other = _tiny_state(seed=1)
    other["step"] = 0
    restored, step = restore_checkpoint(str(tmp_path), other)
    assert step == 3 and restored is other
    _equal(_values(restored), before)


def test_checkpoint_atomic_latest(tmp_path):
    state = _tiny_state()
    save_checkpoint(str(tmp_path), state, 3)
    save_checkpoint(str(tmp_path), state, 10)
    assert latest_step(str(tmp_path)) == 10
    assert not (tmp_path / "LATEST.tmp").exists()
    _, step = restore_checkpoint(str(tmp_path), state)
    assert step == 10
    _, step = restore_checkpoint(str(tmp_path), state, step=3)
    assert step == 3


def test_checkpoint_digest_verification(tmp_path):
    state = _tiny_state()
    d = save_checkpoint(str(tmp_path), state, 1)
    leaf = os.path.join(d, "leaf_1.npy")
    arr = np.load(leaf).copy()
    arr.reshape(-1)[0] += 1
    np.save(leaf, arr)
    target = _tiny_state(seed=2)
    before = _values(target)
    with pytest.raises(IOError, match="digest mismatch on leaf 1"):
        restore_checkpoint(str(tmp_path), target)
    _equal(_values(target), before)   # nothing was written into it


def test_checkpoint_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), _tiny_state(), 1)
    one = state_for(torch.nn.ParameterDict(
        {"just_one": torch.nn.Parameter(torch.zeros(3))}), TrainConfig())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(str(tmp_path), one)
    wrong = _tiny_state()
    wrong["params"]["w"] = torch.nn.Parameter(torch.zeros(4, 9))
    wrong["opt"] = state_for(wrong["params"], TrainConfig())["opt"]
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), wrong)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tiny_state())


def _counter_state():
    return state_for(torch.nn.ParameterDict(
        {"x": torch.nn.Parameter(torch.zeros(()))}), TrainConfig())


def _add(state, batch):
    with torch.no_grad():
        state["params"]["x"].add_(batch)
    state["step"] += 1
    return state, {}


def test_supervisor_restarts_from_checkpoint(tmp_path):
    """A step that crashes twice mid-run resumes from the checkpoint and
    gives the uninterrupted run's final state."""
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] in (4, 9):
            raise RuntimeError("injected device failure")
        return _add(state, batch)

    sup = Supervisor(str(tmp_path), ckpt_every=2, max_restarts=5)
    state, stats = sup.run(_counter_state(), flaky,
                           lambda step: float(step + 1), n_steps=8)
    assert stats["restarts"] == 2
    assert float(state["params"]["x"]) == sum(range(1, 9))
    assert state["step"] == 8


def test_supervisor_restores_the_start_after_a_step_failed_late(tmp_path):
    """A step that raises after its update, before any checkpoint of the
    loop: the restart restores the starting state the supervisor saved,
    so no step is applied twice."""
    failed = []

    def late(state, batch):
        state, m = _add(state, batch)
        if state["step"] == 2 and not failed:
            failed.append(True)
            raise RuntimeError("injected failure after the update")
        return state, m

    sup = Supervisor(str(tmp_path), ckpt_every=100)
    state, stats = sup.run(_counter_state(), late,
                           lambda step: float(step + 1), n_steps=4)
    assert stats["restarts"] == 1
    assert float(state["params"]["x"]) == sum(range(1, 5))
    assert state["step"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_-1", "step_3"]


def test_supervisor_resumes_across_runs(tmp_path):
    sup = Supervisor(str(tmp_path), ckpt_every=2)
    state, _ = sup.run(_counter_state(), _add, lambda step: 1.0, n_steps=4)
    assert float(state["params"]["x"]) == 4.0
    sup2 = Supervisor(str(tmp_path), ckpt_every=2)
    state2, _ = sup2.run(_counter_state(), _add, lambda step: 1.0,
                         n_steps=8)
    assert float(state2["params"]["x"]) == 8.0


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=4.0)
    flagged = [mon.observe(1.0 + 0.01 * (i % 3)) for i in range(20)]
    assert not any(flagged)
    assert mon.observe(5.0)
    assert not mon.observe(1.01)


@pytest.mark.parametrize("at,after_update", [(7, False), (2, True)])
def test_supervisor_run_of_a_model_equals_the_uninterrupted_one(
        tmp_path, at, after_update):
    """A train step that raises once (checkpoints every 5): at step 7
    before its update, resuming from step 4; at step 2 after its update,
    before the loop's first checkpoint, resuming from the starting state.
    Either ends with the parameters and moments of an uninterrupted
    10-step run, bit for bit."""
    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    tcfg = TrainConfig(remat=False)
    stream = TokenStream(cfg.vocab_size, 16, 4)
    step = make_train_step(cfg, tcfg, device="cpu")
    ref = init_train_state(cfg, tcfg, device="cpu")
    for i in range(10):
        ref, _ = step(ref, stream.batch_at(i))
    raised = []

    def once(state, batch):
        if state["step"] == at and not raised and not after_update:
            raised.append(True)
            raise RuntimeError("injected failure")
        state, m = step(state, batch)
        if state["step"] == at + 1 and not raised and after_update:
            raised.append(True)
            raise RuntimeError("injected failure after the update")
        return state, m

    sup = Supervisor(str(tmp_path), ckpt_every=5)
    got, stats = sup.run(init_train_state(cfg, tcfg, device="cpu"), once,
                         stream.batch_at, n_steps=10)
    assert stats["restarts"] == 1
    _equal(_values(got), _values(ref))


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
def _cfgs(arch, dtype="float32"):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype=dtype)
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype=dtype)
    return cj, ct


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    return [(tuple(x["shape"]), x["dtype"], x["crc32"]) for x in m["leaves"]]


@pytest.mark.parametrize("arch,dtype,compress",
                         [("qwen3-0.6b", "float32", False),
                          ("qwen3-0.6b", "bfloat16", False),
                          ("qwen3-0.6b", "float32", True),
                          ("recurrentgemma-9b", "bfloat16", False)])
def test_leaf_files_are_the_references(tmp_path, arch, dtype, compress):
    """The same state written by either package: the same leaf count and,
    leaf for leaf, the same shape, dtype name and crc32; each package
    restores the other's files into its own state, bit for bit."""
    cj, ct = _cfgs(arch, dtype)
    jt = JTrainConfig(grad_compress=compress)
    tt = TrainConfig(grad_compress=compress)
    js = j_init_state(cj, jt)
    js["step"] = jnp.asarray(5, jnp.int32)
    js["opt"]["count"] = jnp.asarray(5, jnp.int32)
    js["opt"]["mu"] = jax.tree.map(lambda p: p * 0.5, js["params"])
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), ct, tt,
                              device="cpu")
    d_ref = j_save(str(tmp_path / "ref"), js, 5)
    d_port = train_state_to_checkpoint(ts, str(tmp_path / "port"), 5)
    assert _manifest(d_port) == _manifest(d_ref)

    # the reference's files into the port, the port's into the reference
    got, step = train_state_from_checkpoint(str(tmp_path / "ref"), ct, tt,
                                            device="cpu")
    assert step == 5
    _equal(_values(got), _values(ts))
    back, step = j_restore(str(tmp_path / "port"), js)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_port_trains_on_from_a_reference_checkpoint(tmp_path):
    """Two reference steps, a reference checkpoint, the port restores it
    (parameters, moments, count, step) and takes the third step as the
    reference does."""
    cj, ct = _cfgs("qwen3-0.6b")
    jt, tt = JTrainConfig(remat=False), TrainConfig(remat=False)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    stream = JTokenStream(cj.vocab_size, 16, 4)
    js = j_init_state(cj, jt)
    _, jit_step, _ = j_make_train_step(cj, jt, mesh)
    run = lambda s, i: jit_step({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                                 for k, v in stream.batch_at(i).items()})(
        s, {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()})
    for i in range(2):
        js, _ = run(js, i)
    j_save(str(tmp_path), js, 1)
    ts, step = train_state_from_checkpoint(str(tmp_path), ct, tt,
                                           device="cpu")
    assert step == 1 and ts["step"] == 2 and ts["opt"]["count"] == 2
    js, jm = run(js, 2)
    ts, tm = make_train_step(ct, tt, device="cpu")(ts, stream.batch_at(2))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert ts["step"] == 3
