"""The port's token stream, batch specs, LUT tables in training and the
training launcher, on the CPU: ``TokenStream`` bit for bit against the
reference's, the launcher's flags, batches, checkpoints, a 2x2 mesh run
and its status 2 for meshes it cannot build (the train step against the
reference's: ``tests/test_torch_train_step.py``; on meshes:
``tests/test_torch_train_sharded.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.data import lm_batch_specs as j_lm_batch_specs
from repro.train import input_batch_specs as j_input_batch_specs
from repro_torch import configs as tconfigs
from repro_torch.data import TokenStream, lm_batch_specs
from repro_torch.launch import train as launcher
from repro_torch.train import (
    TrainConfig,
    init_train_state,
    input_batch_specs,
    make_train_step,
)
from repro_torch.train.checkpoint import state_leaves


def _cfgs(arch):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype="float32")
    return cj, ct


@pytest.mark.parametrize("seed,step,shard,count",
                         [(0, 0, 0, 1), (3, 7, 1, 2), (11, 123456, 3, 4),
                          (2**31 - 1, 5, 0, 8)])
def test_token_stream_is_the_references(seed, step, shard, count):
    kw = dict(vocab_size=151936, seq_len=33, global_batch=8, seed=seed,
              shard_index=shard, shard_count=count)
    want = JTokenStream(**kw).batch_at(step)
    got = TokenStream(**kw).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_token_stream_skip_ahead_and_shards():
    a = TokenStream(1000, 16, 8, seed=3, shard_index=0, shard_count=2)
    b = TokenStream(1000, 16, 8, seed=3, shard_index=1, shard_count=2)
    x = a.batch_at(7)
    assert x["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not np.array_equal(x["tokens"], b.batch_at(7)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        TokenStream(1000, 16, 5, shard_count=2).local_batch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi-3-vision-4.2b",
                                  "whisper-small"])
def test_batch_specs_are_the_references(arch):
    cj, ct = _cfgs(arch)
    want = {k: (tuple(s.shape), np.dtype(s.dtype))
            for k, s in j_input_batch_specs(cj, 4, 24).items()}
    assert input_batch_specs(ct, 4, 24) == want
    assert lm_batch_specs(2, 5) == {
        k: (tuple(s.shape), np.dtype(s.dtype))
        for k, s in j_lm_batch_specs(2, 5).items()}


def test_lut_tables_train_with_gather_only():
    """Compressed activations in the forward train through the ``gather``
    backend; the kernels' ``cuda`` tables are refused (no gradient)."""
    from repro_torch.serve import build_serving_plans

    _, ct = _cfgs("qwen3-0.6b")
    cfg = dataclasses.replace(ct, lut_activation=True)
    plans = build_serving_plans(cfg, np.linspace(-3, 3, 4096))
    with pytest.raises(ValueError, match="gather"):
        make_train_step(cfg, TrainConfig(), device="cpu",
                        lut_tables=plans.tables_for_model(
                            backend="cuda", device="cpu"))
    tables = plans.tables_for_model(backend="gather", device="cpu")
    state = init_train_state(cfg, TrainConfig(remat=False), device="cpu")
    step = make_train_step(cfg, TrainConfig(remat=False), device="cpu",
                           lut_tables=tables)
    before = state["params"].lm_head.detach().clone()
    state, m = step(state, TokenStream(cfg.vocab_size, 8, 2).batch_at(0))
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before, state["params"].lm_head)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    rc = launcher.main(["--device", "cpu", "--arch", "qwen3-0.6b",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "finished at step 3" in out and "restarts=0" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_-1", "step_1", "step_2"]


def test_launcher_run_reports_every_step_and_draws_frames():
    args = launcher.parse_args(["--device", "cpu", "--arch", "whisper-small",
                                "--steps", "4", "--batch", "2", "--seq",
                                "8", "--remat", "--lr", "3e-3"])
    s = launcher.setup(args)
    b0, b0_again = s["batch_at"](0), s["batch_at"](0)
    assert b0["frames"].shape == (2, s["cfg"].n_frames, s["cfg"].d_model)
    np.testing.assert_array_equal(b0["frames"], b0_again["frames"])
    out = launcher.run(args, s, log=lambda m: None)
    assert len(out["losses"]) == 4 and len(out["seconds"]) == 4
    assert all(np.isfinite(out["losses"]))


def test_launcher_resumes_from_its_checkpoint_directory(tmp_path):
    """A run that keeps failing at step 3 gives up; a second run on the
    same directory resumes after the step-1 checkpoint and ends with the
    state of an uninterrupted run, bit for bit."""
    argv = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "8",
            "--ckpt-every", "2"]
    quiet = lambda m: None
    whole = launcher.run(launcher.parse_args(
        argv + ["--ckpt-dir", str(tmp_path / "whole")]), log=quiet)
    args = launcher.parse_args(argv + ["--ckpt-dir", str(tmp_path / "cut")])
    s = launcher.setup(args)

    def fails_at_3(state, batch):
        if state["step"] == 3:
            raise RuntimeError("injected failure at step 3")
        return s["step"](state, batch)

    with pytest.raises(RuntimeError, match="step 3"):
        launcher.run(args, s, log=quiet, step_fn=fails_at_3)
    out = launcher.run(args, log=quiet)
    assert out["state"]["step"] == 4 and len(out["losses"]) == 2
    assert out["losses"] == whole["losses"][2:]
    for (_, a), (_, b) in zip(state_leaves(out["state"]),
                              state_leaves(whole["state"])):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


# flags the launcher refuses, and what its message must say
REFUSED = {("--production-mesh",): "needs 256 ranks",
           ("--multi-pod",): "512 ranks",
           ("--production-mesh", "--multi-pod"): "needs 512 ranks",
           ("--tp", "0"): "must be >= 1"}


@pytest.mark.parametrize("flags", [list(k) for k in REFUSED])
def test_launcher_refuses_meshes_with_status_2(flags, capsys):
    """A mesh that cannot be built here exits with status 2 and says
    why: the production meshes need their 256 (two pods: 512) ranks,
    ``--multi-pod`` alone names the two-pod mesh it needs, a mesh axis
    below 1."""
    with pytest.raises(SystemExit) as info:
        launcher.parse_args(["--device", "cpu"] + flags)
    assert info.value.code == 2
    assert REFUSED[tuple(flags)] in capsys.readouterr().err


def test_launcher_refuses_torchrun_ranks_that_miss_the_mesh(monkeypatch,
                                                           capsys):
    """Under ``torchrun`` the ranks must make ``DP x TP``: 3 for a 2x2
    mesh exits with status 2 before any rank joins."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit) as info:
        launcher.parse_args(["--device", "cpu", "--dp", "2", "--tp", "2"])
    assert info.value.code == 2
    assert "needs 4 ranks, torchrun started 3" in capsys.readouterr().err


def test_launcher_trains_on_a_2x2_mesh():
    """``--dp 2 --tp 2 --device cpu`` runs 2 steps on four spawned ranks:
    every rank reports the same losses, those of the single-device run
    with ``--microbatch 2``, and holds its shares of the state."""
    argv = ["--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16"]
    ranks = launcher.train_mesh(argv + ["--dp", "2", "--tp", "2"])
    one = launcher.run(launcher.parse_args(argv + ["--microbatch", "2"]),
                       log=lambda m: None)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["losses"] == one["losses"] and len(r["losses"]) == 2
        assert r["grad_norms"] == one["grad_norms"]
        assert r["state_bytes"] < launcher.state_bytes(one["state"]) / 2
        assert set(r["splits"][0]) == {"gather_s", "forward_backward_s",
                                       "reduce_s", "update_s"}
