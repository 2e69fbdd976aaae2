"""The partitioned tensor-parallel train step (``tp_mode="partitioned"``,
the dense family) on spawned CPU ranks joined over gloo, held against the
reference's GSPMD train step, against the port's plain functions and
against its own exact mode.

The reference runs once, in a subprocess with 4 forced host devices
(``tests/torch_mesh_train_reference.py partitioned``, ``Auto`` mesh axes),
on float32 smoke configs from ``PRNGKey(0)``: qwen3-0.6b (a gated
``w_in``, whose tp share the step exchanges into ``[gate_i | up_i]``) and
nemotron-4-15b (relu2, no gate), two steps on 1x2 and 2x2 with and
without ``grad_compress``.  Its compressed step raises under this jax on
qwen3 1x2 and on nemotron (the reference script records the errors);
there the partitioned compressed step is held to the same bounds against
the port's exact-mode compressed step on the same mesh, which
``test_torch_train_sharded.py`` holds against the reference and the
single-device step.  Bounds against the reference are
``test_torch_train_sharded.py``'s: step 1's loss within ``1e-5``, each
gradient norm within ``1e-4`` relative, every parameter after 2 steps
within ``2e-3`` (a leaf's mean difference within ``1e-3 * lr``).

Each mesh shape (1x2, 2x2, 1x4) starts its ranks once and runs every
scenario of that shape in them; a test reads its scenario's outcome.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train_sharded import (
    _batches,
    _cfg,
    _crcs,
    _gathered_params,
    _param_diffs,
    _tree,
    run_scenarios,
    sc_restore,
)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "nemotron-4-15b")
SHAPES = ("1x2", "2x2")
LR = 1e-3


# -------------------------------------------------------------------------
# what the ranks run (importable: the ranks are spawned)
# -------------------------------------------------------------------------
def _ref(ref_dir, arch):
    return np.load(os.path.join(ref_dir, f"part_{arch}.npz"))


def _state(arch, ref_dir, **kw):
    """A fresh single-device state on the reference's initial
    parameters."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.train import TrainConfig
    from repro_torch.train.state import state_for

    cfg = _cfg(arch)
    tcfg = TrainConfig(**dict(dict(remat=False), **kw))
    return cfg, tcfg, state_for(params_from_jax(
        _tree(_ref(ref_dir, arch)), cfg, "cpu"), tcfg)


class _GatherSpy:
    """Record every :meth:`Placement.gather` that puts a leaf split over
    the model axis back together whole over it (the model axis not
    kept)."""

    def __enter__(self):
        from repro_torch.nn import sharding

        self.orig, self.whole = sharding.Placement.gather, []
        orig, whole = self.orig, self.whole

        def spy(pl, local, keep=()):
            if (sharding.TP_AXIS not in keep
                    and not pl.only((sharding.TP_AXIS,)).replicated):
                whole.append(tuple(pl.spec))
            return orig(pl, local, keep)

        sharding.Placement.gather = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import sharding

        sharding.Placement.gather = self.orig


def _run(mesh, cfg, tcfg, state, batches, tp_mode):
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, tcfg, "cpu", mesh=mesh, tp_mode=tp_mode)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out, sorted(step.timings)


def sc_steps(mesh, arch, ref_dir, compress):
    """Two partitioned steps from the reference's initial parameters
    (every gather of the steps spied), two exact-mode steps beside them,
    and the reference's record of the mesh."""
    from repro_torch.train import shard_train_state, train_state_shardings

    key = ("c/" if compress else "") + "x".join(
        str(mesh.shape[a]) for a in ("data", "model"))
    ref = _ref(ref_dir, arch)
    out = {"ref_error": (str(ref[f"{key}/error"])
                         if f"{key}/error" in ref.files else None)}
    for mode in ("partitioned", "exact"):
        cfg, tcfg, full = _state(arch, ref_dir, grad_compress=compress)
        sh = train_state_shardings(cfg, tcfg, mesh)
        state = shard_train_state(full, cfg, mesh)
        with _GatherSpy() as spy:
            state, got, timings = _run(mesh, cfg, tcfg, state,
                                       _batches(cfg, 2), mode)
        out[mode] = {"metrics": got, "timings": timings,
                     "whole_gathered": spy.whole,
                     "params": _gathered_params(state, sh)}
    if out["ref_error"] is None:
        out["ref"] = {"loss": ref[f"{key}/loss"].tolist(),
                      "grad_norm": ref[f"{key}/grad_norm"].tolist(),
                      "param_diffs": _param_diffs(
                          out["partitioned"]["params"], ref, f"{key}/p/")}
    exact = {f"p/{k}": v for k, v in out["exact"]["params"].items()}
    out["exact_diffs"] = _param_diffs(out["partitioned"]["params"], exact,
                                      "p/")
    for mode in ("partitioned", "exact"):
        del out[mode]["params"]
    return out


def sc_ops(mesh):
    """The vocab-parallel embedding and cross-entropy against
    ``embed_lookup`` / ``softmax_cross_entropy`` on the whole table and
    logits (values and gradients; the labels and tokens on every rank's
    first and last vocab entries among them), and the gated ``w_in``
    exchange against slicing the whole leaf, both ways."""
    from repro_torch.nn.layers import (
        embed_lookup,
        embed_lookup_tp,
        softmax_cross_entropy,
    )
    from repro_torch.nn.sharding import (
        TP_AXIS,
        gate_up_exchange,
        use_mesh,
        vocab_parallel_cross_entropy,
    )

    n, i = mesh.shape[TP_AXIS], mesh.index(TP_AXIS)
    rng = np.random.default_rng(3)
    vocab, d = 64, 8
    share = vocab // n
    edges = [e for r in range(n) for e in (r * share, r * share + share - 1)]
    ids = torch.from_numpy(np.concatenate([
        edges, rng.integers(0, vocab, 24 - len(edges))]).reshape(2, 12))
    out = {}
    with use_mesh(mesh):
        table = torch.from_numpy(rng.normal(size=(vocab, d)).astype(
            np.float32)).requires_grad_(True)
        local = table.detach()[i * share:(i + 1) * share].clone()
        local.requires_grad_(True)
        w = torch.from_numpy(rng.normal(size=(2, 12, d)).astype(np.float32))
        got, want = embed_lookup_tp(local, ids, i * share), \
            embed_lookup(table, ids)
        (got * w).sum().backward()
        (want * w).sum().backward()
        out["embed"] = float((got - want).abs().max())
        out["embed_grad"] = float((local.grad - table.grad[
            i * share:(i + 1) * share]).abs().max())
        logits = torch.from_numpy(5 * rng.normal(size=(2, 12, vocab)).astype(
            np.float32)).requires_grad_(True)
        mine = logits.detach()[..., i * share:(i + 1) * share].clone()
        mine.requires_grad_(True)
        got = vocab_parallel_cross_entropy(mine, ids, i * share)
        want = softmax_cross_entropy(logits, ids)
        got.backward()
        want.backward()
        out["ce"] = abs(float(got) - float(want))
        out["ce_grad"] = float((mine.grad - logits.grad[
            ..., i * share:(i + 1) * share]).abs().max())
        ff = 4 * n
        whole = torch.from_numpy(rng.normal(size=(2, d, 2 * ff)).astype(
            np.float32)).to(torch.bfloat16)
        s = ff // n
        stored = whole[..., 2 * i * s:2 * (i + 1) * s]
        compute = gate_up_exchange(stored.clone(), mesh)
        want = torch.cat([whole[..., i * s:(i + 1) * s],
                          whole[..., ff + i * s:ff + (i + 1) * s]], dim=-1)
        out["exchange"] = torch.equal(compute, want)
        out["exchange_back"] = torch.equal(
            gate_up_exchange(compute, mesh, inverse=True), stored)
    return out


def sc_save(mesh, ref_dir, ckpt_dir):
    """qwen3-0.6b, 2 partitioned steps on this mesh, the state saved at
    step 2 (rank 0 writes)."""
    from repro_torch.train import (
        save_checkpoint,
        shard_train_state,
        train_state_shardings,
    )

    cfg, tcfg, full = _state("qwen3-0.6b", ref_dir)
    sh = train_state_shardings(cfg, tcfg, mesh)
    state, got, _ = _run(mesh, cfg, tcfg, shard_train_state(full, cfg, mesh),
                         _batches(cfg, 2), "partitioned")
    save_checkpoint(ckpt_dir, state, 2, shardings=sh)
    return {"crcs": _crcs(state, sh), "metrics": got}


def sc_launcher(mesh):
    """``launch/train``'s set-up with ``--tp-mode partitioned``: its step
    is the partitioned one (no whole split leaf gathered), equal to
    :func:`make_train_step`'s on the same state."""
    from repro_torch.launch import train as tl
    from repro_torch.train import init_train_state

    argv = ["--device", "cpu", "--tp", str(mesh.shape["model"]),
            "--steps", "2", "--batch", "4", "--seq", "16",
            "--tp-mode", "partitioned"]
    args = tl.parse_args(argv)
    s = tl.setup(args, mesh=mesh)
    out = {"default": tl.parse_args(argv[:-2]).tp_mode, "launcher": []}
    batches = [s["batch_at"](i) for i in (0, 1)]
    state = s["state"]
    with _GatherSpy() as spy:
        for b in batches:
            state, m = s["step"](state, b)
            out["launcher"].append((float(m["loss"]), float(m["grad_norm"])))
    out["whole_gathered"] = spy.whole
    state = init_train_state(s["cfg"], tl.train_config(args), device="cpu",
                             mesh=mesh)
    _, out["direct"], _ = _run(mesh, s["cfg"], tl.train_config(args), state,
                               batches, "partitioned")
    return out


# -------------------------------------------------------------------------
# the reference once, then one spawn a mesh shape
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("part_ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_mesh_train_reference.py"),
                        str(tmp), "partitioned"], env=env,
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(tmp)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("part_ckpt"))


def _spawn(dp, tp, scenarios):
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(run_scenarios, (scenarios,), dp=dp, tp=tp,
                     device="cpu", timeout=600)


def _steps(ref_dir):
    return [(f"steps-{a}-{c}", sc_steps,
             {"arch": a, "ref_dir": ref_dir, "compress": c})
            for a in ARCHS for c in (False, True)] + [("ops", sc_ops, {})]


@pytest.fixture(scope="module")
def mesh22(ref_dir, ckpt_dir):
    return _spawn(2, 2, _steps(ref_dir) + [
        ("save", sc_save, {"ref_dir": ref_dir, "ckpt_dir": ckpt_dir})])


@pytest.fixture(scope="module")
def mesh12(ref_dir):
    return _spawn(1, 2, _steps(ref_dir) + [("launcher", sc_launcher, {})])


@pytest.fixture(scope="module")
def mesh14(ckpt_dir, mesh22):
    return _spawn(1, 4, [("ops", sc_ops, {}),
                         ("restore", sc_restore, {"ckpt_dir": ckpt_dir})])


def _outcome(ranks, name):
    """The scenario's result on rank 0, after every rank ran it."""
    for r, res in enumerate(ranks):
        status, val = res[name]
        assert status == "ok", f"rank {r}, {name}:\n{val}"
    return ranks[0][name][1]


def _mesh(request, shape):
    return request.getfixturevalue("mesh" + shape.replace("x", ""))


# -------------------------------------------------------------------------
# the partitioned step
# -------------------------------------------------------------------------
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_step_matches_reference(request, shape, arch, compress):
    """Against the reference's GSPMD step (where its compressed step runs;
    else against the port's exact-mode step on the mesh, module
    docstring): step 1's loss within 1e-5, each gradient norm within 1e-4
    relative, every parameter after 2 steps within 2e-3 and each leaf's
    mean difference within ``1e-3 * lr``.  Every rank reports the same
    metrics."""
    ranks = _mesh(request, shape)
    name = f"steps-{arch}-{compress}"
    out = _outcome(ranks, name)
    got = out["partitioned"]["metrics"]
    for r in ranks:
        assert r[name][1]["partitioned"]["metrics"] == got
    if out["ref_error"] is None:
        want = list(zip(out["ref"]["loss"], out["ref"]["grad_norm"]))
        diffs = out["ref"]["param_diffs"]
    else:
        assert compress and (arch != "qwen3-0.6b" or shape == "1x2"), \
            out["ref_error"]
        want, diffs = out["exact"]["metrics"], out["exact_diffs"]
    assert abs(got[0][0] - want[0][0]) <= 1e-5
    for (_, g), (_, r) in zip(got, want):
        assert abs(g - r) <= 1e-4 * r, (g, r)
    for n, (mean, top) in diffs.items():
        assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_step_gathers_no_whole_split_leaf(request, shape, arch,
                                                      compress):
    """No gather of the partitioned steps puts a leaf split over the model
    axis back together whole over it (exact mode's steps do, for every
    such leaf); the step's timings keep exact mode's four keys."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}-{compress}")
    assert out["partitioned"]["whole_gathered"] == []
    assert out["exact"]["whole_gathered"]
    assert out["partitioned"]["timings"] == out["exact"]["timings"] == [
        "forward_backward_s", "gather_s", "reduce_s", "update_s"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_step_near_exact_mode(request, shape, arch):
    """The two modes compute the same sums associated otherwise (the
    row-parallel products' partial sums, the vocab-split log-sum-exp):
    losses and norms within 1e-5 relative, parameters after 2 steps as
    against the reference."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}-False")
    for (l, g), (wl, wg) in zip(out["partitioned"]["metrics"],
                                out["exact"]["metrics"]):
        assert abs(l - wl) <= 1e-5 * wl and abs(g - wg) <= 1e-5 * wg
    for n, (mean, top) in out["exact_diffs"].items():
        assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)


# -------------------------------------------------------------------------
# the operators
# -------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_vocab_parallel_embedding_and_cross_entropy(request, shape):
    """On every rank: the vocab-parallel embedding and its table
    gradient, the vocab-parallel cross-entropy and its logits gradient
    within 1e-6 of the plain functions on the whole table and logits,
    with tokens and labels on every rank's first and last entries."""
    for r, res in enumerate(_mesh(request, shape)):
        status, out = res["ops"]
        assert status == "ok", out
        for k in ("embed", "embed_grad", "ce", "ce_grad"):
            assert out[k] <= 1e-6, (r, k, out[k])


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_gate_up_exchange_is_slicing_the_whole_leaf(request, shape):
    """Every rank's exchanged ``w_in`` share is ``[gate_i | up_i]`` of the
    whole leaf bit for bit, and the inverse exchange gives back its
    stored share bit for bit."""
    for r, res in enumerate(_mesh(request, shape)):
        status, out = res["ops"]
        assert status == "ok", out
        assert out["exchange"] and out["exchange_back"], r


# -------------------------------------------------------------------------
# checkpoints, the launcher, the refusals, the dry run
# -------------------------------------------------------------------------
def test_partitioned_checkpoint_restored_on_exact_1x4(mesh22, mesh14):
    """The 2x2 partitioned state after 2 steps restored onto 1x4 in exact
    mode: the gathered leaves are the files', and step 3 there is the
    single-device step from the checkpoint bit for bit."""
    saved = _outcome(mesh22, "save")
    out = _outcome(mesh14, "restore")
    assert out["step"] == 2 and out["restored"] == saved["crcs"]
    assert out["metrics"] == out["single"] and out["crc_equal"]


def test_launcher_tp_mode(mesh12):
    """``--tp-mode`` defaults to exact; ``partitioned`` gives the
    launcher's set-up the partitioned step."""
    out = _outcome(mesh12, "launcher")
    assert out["default"] == "exact"
    assert out["whole_gathered"] == []
    assert out["launcher"] == out["direct"]


def test_tp_mode_refusals():
    """A mode but the two raises; so does ``"partitioned"`` on a family
    other than dense (naming it) or with LUT tables; the launcher refuses
    another mode with status 2."""
    from repro_torch.launch import train as tl
    from repro_torch.train import TrainConfig, make_train_step

    tcfg = TrainConfig(remat=False)
    with pytest.raises(ValueError, match="tp_mode 'bogus'"):
        make_train_step(_cfg("qwen3-0.6b"), tcfg, "cpu", tp_mode="bogus")
    for arch, family in (("deepseek-moe-16b", "moe"), ("rwkv6-3b", "ssm"),
                         ("whisper-small", "encdec")):
        with pytest.raises(ValueError, match=f"not '{family}'"):
            make_train_step(_cfg(arch), tcfg, "cpu", tp_mode="partitioned")
    with pytest.raises(ValueError, match="no LUT tables"):
        make_train_step(_cfg("qwen3-0.6b"), tcfg, "cpu",
                        lut_tables={"backend": "gather"},
                        tp_mode="partitioned")
    with pytest.raises(SystemExit) as e:
        tl.parse_args(["--tp-mode", "bogus"])
    assert e.value.code == 2


def _trace(tp_mode):
    from repro_torch.launch.dryrun import fake_group, trace_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(_cfg("qwen3-0.6b"), dtype="bfloat16")
    with fake_group(2):
        tr = trace_step(cfg, "train", 4, 16, mesh=make_host_mesh(1, 2),
                        tcfg=TrainConfig(remat=False), tp_mode=tp_mode)
    return tr["costs"]


def test_dryrun_partitioned_rank_halves_the_products():
    """One 1x2 rank's step traced on the meta device: the counted FLOPs
    of the products (the blocks' and the head's ``mm``, attention's
    ``bmm``) are half the exact rank's; the partitioned rank all-reduces
    and exchanges, and gathers nothing (dp 1); ``dryrun_cell`` records the
    mode."""
    from repro_torch.launch.dryrun import dryrun_cell

    exact, part = _trace("exact"), _trace("partitioned")
    for op in ("aten.mm", "aten.bmm"):
        assert part.per_comp_flops[op] * 2 == exact.per_comp_flops[op], op
    assert part.per_op_coll.get("all-reduce", 0) > 0
    assert part.per_op_coll.get("all-to-all", 0) > 0
    assert "all-gather" not in part.per_op_coll
    assert exact.per_op_coll.get("all-gather", 0) > 0
    cfg = dataclasses.replace(_cfg("qwen3-0.6b"), dtype="bfloat16")
    cell = dryrun_cell("qwen3-0.6b", "train_4k", False, quiet=True, cfg=cfg,
                       info=dict(kind="train", seq=16, batch=4),
                       mesh_shape=(1, 2), tp_mode="partitioned")
    assert cell["status"] == "ok", cell.get("trace")
    assert cell["tp_mode"] == "partitioned"
    skipped = dryrun_cell("qwen3-0.6b", "decode_32k", False, quiet=True,
                          tp_mode="partitioned")
    assert skipped["status"] == "skipped"
