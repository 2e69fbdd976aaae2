"""Sharded training on spawned CPU ranks joined over gloo
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.train`), held against
the port's single-device step and the reference's meshed step.

The reference runs once, in a subprocess with 4 forced host devices
(``tests/torch_mesh_train_reference.py``, ``Auto`` mesh axes), on float32
smoke configs from ``PRNGKey(0)``; the port's ranks start from the same
parameters, carried across by the bridge.  Each mesh shape starts its
ranks once (a module fixture) and runs every scenario of that shape in
them; a test reads its scenario's outcome.  Batches are ``TokenStream``'s
4 x 16 (seed 0).

Tolerances against the reference (it runs the global batch through
GSPMD-partitioned programs, which sum in other orders than the port's
single-device shapes): the step-1 loss within ``1e-5``; the gradient norm
within ``1e-4`` relative; every parameter after 2 steps within ``2e-3``
absolute.  AdamW at lr 1e-3 moves an entry by about ``lr`` a step
whatever its gradient's size (at step 1 by ``g / (|g| + eps)``), so a
near-zero gradient whose float32 sum falls the other way can move an
entry up to ``lr`` each way a step; a wrong gradient moves the mean of a
leaf, which is held to ``1e-3 * lr``.  Against the port's single-device
step the sharded step is held bit for bit (module docstring of
:mod:`repro_torch.train.step`).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "rwkv6-3b", "deepseek-moe-16b")
SHAPES = ("2x1", "1x2", "2x2")
LR = 1e-3
BATCH, SEQ = 4, 16


# -------------------------------------------------------------------------
# what the ranks run (importable: the ranks are spawned)
# -------------------------------------------------------------------------
def _cfg(arch):
    from repro_torch.configs import get_config, smoke_config

    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32")


def _ref(ref_dir, name):
    return np.load(os.path.join(ref_dir, f"{name}.npz"))


def _tree(ref, prefix="p/"):
    tree = {}
    for k in ref.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[k]
    return tree


def _full_state(arch, ref_dir, **kw):
    """A fresh single-device state on the reference's initial
    parameters."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.train import TrainConfig
    from repro_torch.train.state import state_for

    cfg = _cfg(arch)
    tcfg = TrainConfig(**dict(dict(remat=False), **kw))
    ref = _ref(ref_dir, arch)
    return cfg, tcfg, state_for(params_from_jax(_tree(ref), cfg, "cpu"),
                                tcfg)


def _batches(cfg, n, start=0):
    from repro_torch.data import TokenStream

    stream = TokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)
    return [stream.batch_at(i) for i in range(start, n)]


def _single(cfg, tcfg, state, n_dp, batches):
    """The single-device step with ``microbatch = n_dp`` (None at 1) on
    ``batches``: (state, [(loss, grad norm)])."""
    from repro_torch.train import make_train_step

    micro = tcfg.microbatch or (n_dp if n_dp > 1 else None)
    step = make_train_step(cfg, dataclasses.replace(tcfg, microbatch=micro),
                           "cpu")
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _sharded(mesh, cfg, tcfg, state, batches):
    from repro_torch.train import make_train_step

    step = make_train_step(cfg, tcfg, "cpu", mesh=mesh)
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


def _n_dp(mesh):
    return mesh.shape["data"]


def _crcs(state, shardings=None):
    """``[(shape, dtype, crc32)]`` a leaf as a checkpoint stores it, the
    leaves gathered under ``shardings`` (a collective; None on ranks but
    0, as only rank 0 writes)."""
    import zlib

    from repro_torch.train.checkpoint import _to_storable, full_leaves

    rank0 = shardings is None or shardings["step"].mesh.rank == 0
    out = []
    for _, leaf in full_leaves(state, shardings):
        if rank0:
            stored, name = _to_storable(leaf)
            out.append((list(stored.shape), name,
                        zlib.crc32(stored.tobytes())))
    return out if rank0 else None


def _gathered_params(state, shardings):
    from repro_torch.train.checkpoint import full_leaves

    return {p[len("params."):]: leaf.detach().numpy()
            for p, leaf in full_leaves(state, shardings)
            if p.startswith("params.")}


def _param_diffs(got: dict, ref, prefix) -> dict:
    """``{name: (mean |d|, max |d|)}`` against the reference's."""
    return {n: (float(np.abs(v - ref[prefix + n]).mean()),
                float(np.abs(v - ref[prefix + n]).max()))
            for n, v in got.items()}


def sc_steps(mesh, arch, ref_dir):
    """Two sharded steps against the single-device ``microbatch = dp``
    step (bit for bit) and the reference's meshed step."""
    from repro_torch.train import shard_train_state, train_state_shardings

    cfg, tcfg, full = _full_state(arch, ref_dir)
    _, _, one = _full_state(arch, ref_dir)
    sh = train_state_shardings(cfg, tcfg, mesh)
    state = shard_train_state(full, cfg, mesh)
    batches = _batches(cfg, 2)
    state, got = _sharded(mesh, cfg, tcfg, state, batches)
    one, want = _single(cfg, tcfg, one, _n_dp(mesh), batches)
    key = "x".join(str(mesh.shape[a]) for a in ("data", "model"))
    ref = _ref(ref_dir, arch)
    return {"metrics": got, "single": want,
            "crc_equal": _crcs(state, sh) == _crcs(one),
            "ref_loss": ref[f"{key}/loss"].tolist(),
            "ref_grad_norm": ref[f"{key}/grad_norm"].tolist(),
            "param_diffs": _param_diffs(_gathered_params(state, sh), ref,
                                        f"{key}/p/")}


def sc_microbatch(mesh, ref_dir):
    """``microbatch=2`` within each data rank against the single-device
    ``microbatch = 2 * dp``: the same sums, associated otherwise."""
    from repro_torch.train import shard_train_state, train_state_shardings

    cfg, tcfg, full = _full_state("qwen3-0.6b", ref_dir, microbatch=2)
    _, _, one = _full_state("qwen3-0.6b", ref_dir)
    sh = train_state_shardings(cfg, tcfg, mesh)
    batches = _batches(cfg, 2)
    state, got = _sharded(mesh, cfg, tcfg, shard_train_state(full, cfg, mesh),
                          batches)
    one, want = _single(cfg, dataclasses.replace(
        tcfg, microbatch=2 * _n_dp(mesh)), one, 1, batches)
    single = {n: p.detach().numpy()
              for n, p in one["params"].named_parameters()}
    return {"metrics": got, "single": want,
            "param_diffs": _param_diffs(_gathered_params(state, sh),
                                        {f"p/{k}": v
                                         for k, v in single.items()}, "p/")}


def sc_compress(mesh, ref_dir):
    """``grad_compress`` on 2x2 for 4 steps against the reference's, the
    uncompressed run beside it (``tests/test_runtime.py``'s checks), the
    error buffers after 2 steps (gathered, and each data rank's own
    replicated ones), and step 1's mean gradient recounted from the ranks'
    int8 codes and scales."""
    from repro_torch.train import shard_train_state, train_state_shardings
    from repro_torch.train import step as step_mod
    from repro_torch.train.checkpoint import full_leaves
    from repro_torch.train.compression import ef_compress_grads

    ref = _ref(ref_dir, "compress")
    out = {}
    names = None
    for key, compress in (("c", True), ("u", False)):
        cfg, tcfg, full = _full_state("qwen3-0.6b", ref_dir,
                                      grad_compress=compress)
        names = [n for n, _ in full["params"].named_parameters()]
        sh = train_state_shardings(cfg, tcfg, mesh)
        state = shard_train_state(full, cfg, mesh)
        calls = []
        orig = step_mod.compressed_dp_mean

        def spy(g, e, *a):
            mean, new_e = orig(g, e, *a)
            if len(calls) < len(names):
                q, s, _ = ef_compress_grads(g, e)
                calls.append((q[0], s[0], mean[0]))
            return mean, new_e

        step_mod.compressed_dp_mean = spy
        try:
            batches = _batches(cfg, 4)
            state, m2 = _sharded(mesh, cfg, tcfg, state, batches[:2])
            if compress:
                e_full = {p[len("ef_error."):]: leaf.numpy()
                          for p, leaf in full_leaves(state, sh)
                          if p.startswith("ef_error.")}
                own = {n: e.numpy() for n, e, pl in zip(
                    names, state["ef_error"],
                    (sh["ef_error"][n] for n in names)) if pl.replicated}
                out["ef_full"] = e_full
                out["ef_own"] = own
                out["param_diffs"] = _param_diffs(
                    _gathered_params(state, sh), ref, "p/")
                out["codes"] = calls
            state, m4 = _sharded(mesh, cfg, tcfg, state, batches[2:])
        finally:
            step_mod.compressed_dp_mean = orig
        out[key] = m2 + m4
    out["names"] = names
    return out


def sc_dp_mean(mesh, ref_dir):
    """``compressed_dp_mean`` on the reference's inputs, each data rank
    its own shard's."""
    from repro_torch.train.compression import compressed_dp_mean

    ref = _ref(ref_dir, "dp_mean")
    d = mesh.index("data")
    n = len([k for k in ref.files if k.startswith("mean")])
    g = [torch.from_numpy(ref[f"g{j}/d{d}"]) for j in range(n)]
    e = [torch.from_numpy(ref[f"e{j}/d{d}"]) for j in range(n)]
    mean, new_e = compressed_dp_mean(g, e, mesh, ("pod", "data"))
    from repro_torch.train.compression import ef_compress_grads
    from repro_torch.nn.sharding import all_reduce

    q8, _, _ = ef_compress_grads(g, e)
    sums = [all_reduce(q.to(torch.int32), mesh, "data").numpy() for q in q8]
    return {"mean": [m.numpy() for m in mean],
            "new_e": [x.numpy() for x in new_e], "sums": sums,
            "data": d}


def sc_experts(mesh, compress):
    """deepseek-moe-16b, 2 steps on this mesh from the port's own initial
    state (seed 0), every gather of the step recorded; under compression
    each call of ``compressed_dp_mean`` on an expert stack's share held
    against the same call on the whole leaves (gathered over the model
    axis here, outside the step), sliced to the rank's experts.  Without
    compression, and with it at dp 1, the single-device ``microbatch =
    dp`` step beside it."""
    from repro_torch.nn import sharding
    from repro_torch.train import (
        TrainConfig,
        init_train_state,
        shard_train_state,
        train_state_shardings,
    )
    from repro_torch.train import step as step_mod

    cfg = _cfg("deepseek-moe-16b")
    tcfg = TrainConfig(remat=False, grad_compress=compress)
    full = init_train_state(cfg, tcfg, device="cpu")
    whole = {tuple(p.shape) for n, p in full["params"].named_parameters()
             if n.rsplit(".", 1)[-1] in ("moe_w_in", "moe_w_out")}
    sh = train_state_shardings(cfg, tcfg, mesh)
    state = shard_train_state(full, cfg, mesh)
    del full
    gather, dp_mean = sharding.gather, step_mod.compressed_dp_mean
    gathered, checks = [], []

    def gather_spy(t, *a, **kw):
        out = gather(t, *a, **kw)
        gathered.append(tuple(out.shape))
        return out

    def dp_mean_spy(g, e, m, dp_axes, share_axes=()):
        mean, new_e = dp_mean(g, e, m, dp_axes, share_axes)
        if share_axes:
            gw, ew = (gather(x[0], m, "model", dim=1) for x in (g, e))
            (mw,), (new_w,) = dp_mean([gw], [ew], m, dp_axes)
            n = g[0].shape[1]
            cut = slice(m.index("model") * n, (m.index("model") + 1) * n)
            checks.append((torch.equal(mean[0], mw[:, cut]),
                           torch.equal(new_e[0], new_w[:, cut])))
        return mean, new_e

    sharding.gather, step_mod.compressed_dp_mean = gather_spy, dp_mean_spy
    try:
        state, got = _sharded(mesh, cfg, tcfg, state, _batches(cfg, 2))
    finally:
        sharding.gather, step_mod.compressed_dp_mean = gather, dp_mean
    out = {"metrics": got, "tp": mesh.shape["model"],
           "whole_gathered": [s for s in gathered if s in whole],
           "checks": checks}
    if not compress or _n_dp(mesh) == 1:
        one = init_train_state(cfg, tcfg, device="cpu")
        one, out["single"] = _single(cfg, tcfg, one, _n_dp(mesh),
                                     _batches(cfg, 2))
        out["crc_equal"] = _crcs(state, sh) == _crcs(one)
    return out


def sc_save(mesh, ref_dir, ckpt_dir):
    """The 2x2 state after 2 qwen3 steps saved (rank 0 writes), and one
    more step's record: what the other meshes restore and repeat."""
    from repro_torch.train import (
        save_checkpoint,
        shard_train_state,
        train_state_shardings,
    )

    cfg, tcfg, full = _full_state("qwen3-0.6b", ref_dir)
    sh = train_state_shardings(cfg, tcfg, mesh)
    state = shard_train_state(full, cfg, mesh)
    state, _ = _sharded(mesh, cfg, tcfg, state, _batches(cfg, 2))
    save_checkpoint(ckpt_dir, state, 2, shardings=sh)
    crcs = _crcs(state, sh)
    _, m3 = _sharded(mesh, cfg, tcfg, state, _batches(cfg, 3, start=2))
    return {"crcs": crcs, "step3": m3}


def sc_restore(mesh, ckpt_dir, ref_ckpt=None):
    """Restore a checkpoint onto this mesh over a different state: its
    leaves gathered equal the checkpoint's, and a step from it equals the
    single-device ``microbatch = dp`` step from it."""
    from repro_torch.train import (
        TrainConfig,
        init_train_state,
        restore_checkpoint,
        train_state_shardings,
    )

    cfg = _cfg("qwen3-0.6b")
    tcfg = TrainConfig(remat=False, seed=7)
    sh = train_state_shardings(cfg, tcfg, mesh)
    state = init_train_state(cfg, tcfg, device="cpu", mesh=mesh)
    state, step = restore_checkpoint(ckpt_dir, state, shardings=sh)
    restored = _crcs(state, sh)
    one, _ = restore_checkpoint(ckpt_dir, init_train_state(
        cfg, tcfg, device="cpu"))
    batches = _batches(cfg, step + 1, start=step)
    state, got = _sharded(mesh, cfg, tcfg, state, batches)
    one, want = _single(cfg, tcfg, one, _n_dp(mesh), batches)
    return {"step": step, "restored": restored, "metrics": got,
            "single": want, "crc_equal": _crcs(state, sh) == _crcs(one)}


def sc_supervisor(mesh, ref_dir):
    """A supervised 4-step run, checkpoints every 2, with rank 1 failing
    once at the end of step 2, against an uninterrupted run: every rank
    restores from step 1 and the end states are equal bit for bit."""
    import torch.distributed as dist

    from repro_torch.train import (
        Supervisor,
        shard_train_state,
        train_state_shardings,
    )

    dirs = [tempfile.mkdtemp(prefix="sup_") if mesh.rank == 0 else None
            for _ in range(2)]
    dist.broadcast_object_list(dirs, src=0)
    out = {}
    for label, d in zip(("whole", "failed"), dirs):
        cfg, tcfg, full = _full_state("qwen3-0.6b", ref_dir)
        sh = train_state_shardings(cfg, tcfg, mesh)
        from repro_torch.train import make_train_step

        step = make_train_step(cfg, tcfg, "cpu", mesh=mesh)
        raised = []

        def once(state, batch):
            state, m = step(state, batch)
            if (label == "failed" and mesh.rank == 1 and state["step"] == 3
                    and not raised):
                raised.append(True)
                raise RuntimeError("injected failure on rank 1")
            return state, m

        losses = {}
        state, stats = Supervisor(d, ckpt_every=2, shardings=sh).run(
            shard_train_state(full, cfg, mesh), once,
            lambda i: _batches(cfg, i + 1, start=i)[0], 4,
            on_metrics=lambda i, m: losses.__setitem__(i, float(m["loss"])))
        out[label] = {"crcs": _crcs(state, sh), "restarts": stats["restarts"],
                      "losses": [losses[k] for k in sorted(losses)],
                      "step": state["step"]}
    return out


def sc_ref_ckpt(mesh, ref_dir):
    """The reference's 2x2 checkpoint restored onto this mesh: the
    gathered leaves' ``(shape, dtype, crc32)`` are the files'."""
    return sc_restore(mesh, os.path.join(ref_dir, "ckpt"))


def run_scenarios(mesh, scenarios):
    """Every ``(name, fn, kwargs)`` on this rank, in order: ``{name:
    ("ok", result) or ("error", traceback)}``."""
    torch.set_num_threads(1)   # the ranks share the host's cores
    out = {}
    for name, fn, kw in scenarios:
        try:
            out[name] = ("ok", fn(mesh, **kw))
        except Exception:   # noqa: BLE001 — reported per scenario
            out[name] = ("error", traceback.format_exc())
    return out


# -------------------------------------------------------------------------
# the reference once, then one spawn a mesh shape
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_mesh_train_reference.py"),
                        str(tmp)], env=env, capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(tmp)


def _spawn(dp, tp, scenarios):
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(run_scenarios, (scenarios,), dp=dp, tp=tp,
                     device="cpu", timeout=900)


def _steps(ref_dir):
    return [(f"steps-{a}", sc_steps, {"arch": a, "ref_dir": ref_dir})
            for a in ARCHS] + [
        (f"experts-{c}", sc_experts, {"compress": c}) for c in (False, True)]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt22"))


@pytest.fixture(scope="module")
def mesh22(ref_dir, ckpt_dir):
    return _spawn(2, 2, _steps(ref_dir) + [
        ("dp_mean", sc_dp_mean, {"ref_dir": ref_dir}),
        ("microbatch", sc_microbatch, {"ref_dir": ref_dir}),
        ("compress", sc_compress, {"ref_dir": ref_dir}),
        ("save", sc_save, {"ref_dir": ref_dir, "ckpt_dir": ckpt_dir}),
        ("ref_ckpt", sc_ref_ckpt, {"ref_dir": ref_dir}),
    ])


@pytest.fixture(scope="module")
def mesh21(ref_dir, ckpt_dir, mesh22):
    return _spawn(2, 1, _steps(ref_dir) + [
        ("restore", sc_restore, {"ckpt_dir": ckpt_dir}),
        ("supervisor", sc_supervisor, {"ref_dir": ref_dir}),
    ])


@pytest.fixture(scope="module")
def mesh12(ref_dir, ckpt_dir, mesh22):
    return _spawn(1, 2, _steps(ref_dir) + [
        ("restore", sc_restore, {"ckpt_dir": ckpt_dir}),
    ])


def _outcome(ranks, name):
    """The scenario's result on rank 0, after every rank ran it."""
    for r, res in enumerate(ranks):
        status, val = res[name]
        assert status == "ok", f"rank {r}, {name}:\n{val}"
    return ranks[0][name][1]


def _mesh(request, shape):
    return request.getfixturevalue("mesh" + shape.replace("x", ""))


# -------------------------------------------------------------------------
# placements (no process group)
# -------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b",
                                  "rwkv6-3b", "phi-3-vision-4.2b"])
def test_train_state_shardings_match_reference(ref_dir, arch):
    import json

    from repro_torch.nn.sharding import Mesh
    from repro_torch.train import TrainConfig, train_state_shardings

    with open(os.path.join(ref_dir, "specs.json")) as f:
        want = json.load(f)[arch]
    mesh = Mesh(("data", "model"), (2, 2))
    sh = train_state_shardings(_cfg(arch), TrainConfig(grad_compress=True),
                               mesh)
    got = {}
    for key in ("params", "ef_error"):
        got.update({f"{key}.{n}": pl.spec for n, pl in sh[key].items()})
    for key in ("mu", "nu"):
        got.update({f"opt.{key}.{n}": pl.spec
                    for n, pl in sh["opt"][key].items()})
    got["opt.count"], got["step"] = sh["opt"]["count"].spec, sh["step"].spec
    norm = lambda spec: [list(a) if isinstance(a, tuple) else a
                         for a in spec]
    assert {k: norm(v) for k, v in got.items()} == want


# -------------------------------------------------------------------------
# the sharded step
# -------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_is_single_device_microbatch_dp(request, shape, arch):
    """Losses, gradient norms and every gathered leaf (parameters,
    moments, counters; moe ``aux`` inside the loss) bit for bit."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}")
    assert out["metrics"] == out["single"]
    assert out["crc_equal"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_reference(request, shape, arch):
    """Step 1's loss within 1e-5, every gradient norm within 1e-4
    relative, parameters after 2 steps within 2e-3 (module docstring),
    each leaf's mean difference within ``1e-3 * lr``."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}")
    (l1, g1), (_, g2) = out["metrics"]
    assert abs(l1 - out["ref_loss"][0]) <= 1e-5
    for g, r in zip((g1, g2), out["ref_grad_norm"]):
        assert abs(g - r) <= 1e-4 * r, (g, r)
    for n, (mean, top) in out["param_diffs"].items():
        assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_expert_gradients_stay_shares(request, shape, compress):
    """deepseek-moe-16b on every mesh shape, with and without
    ``grad_compress``: with the experts split (tp > 1) no gather of the
    step has a whole expert stack's shape; under compression each expert
    call's mean and new error are bit for bit the slices of the
    whole-leaf call (both stacks, both steps); the metrics are equal and
    finite on every rank, and without compression (or at dp 1 with it)
    bit for bit the single-device ``microbatch = dp`` step, state
    included."""
    ranks = _mesh(request, shape)
    out = _outcome(ranks, f"experts-{compress}")
    if out["tp"] > 1:
        assert out["whole_gathered"] == []
    if compress and out["tp"] > 1:
        assert out["checks"] == [(True, True)] * 4
    else:
        assert out["checks"] == []
    for r in ranks:
        assert r[f"experts-{compress}"][1]["metrics"] == out["metrics"]
    assert np.all(np.isfinite(out["metrics"]))
    if "single" in out:
        assert out["metrics"] == out["single"] and out["crc_equal"]
    else:
        assert compress and shape != "1x2"


def test_microbatch_within_each_data_rank(mesh22):
    """``microbatch=2`` on 2x2 against the single-device ``microbatch=4``:
    the same float32 sums associated per rank, so within float32 rounding
    (loss and norm 1e-6 relative), parameters as against the reference."""
    out = _outcome(mesh22, "microbatch")
    for (l, g), (wl, wg) in zip(out["metrics"], out["single"]):
        assert abs(l - wl) <= 1e-6 * wl and abs(g - wg) <= 1e-6 * wg
    for n, (mean, top) in out["param_diffs"].items():
        assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)


# -------------------------------------------------------------------------
# int8 error-feedback compression
# -------------------------------------------------------------------------
def test_compressed_dp_mean_matches_reference(mesh22, ref_dir):
    """Each data rank with its own gradients: the int32 sums equal the
    reference's codes summed, the mean is equal on every rank and within
    1e-6 relative of the reference's, each rank's new error is its own
    shard's, bit for bit."""
    ref = _ref(ref_dir, "dp_mean")
    outs = [r["dp_mean"] for r in mesh22]
    assert all(s == "ok" for s, _ in outs), outs
    for _, o in outs:
        d = o["data"]
        for j, (m, s, e) in enumerate(zip(o["mean"], o["sums"], o["new_e"])):
            want = ref[f"q{j}/d0"].astype(np.int32) + ref[f"q{j}/d1"]
            np.testing.assert_array_equal(s, want)
            rm = ref[f"mean{j}"]
            assert np.all(np.abs(m - rm) <= 1e-6 * np.abs(rm).max()), j
            np.testing.assert_array_equal(m, outs[0][1]["mean"][j])
            np.testing.assert_array_equal(e, ref[f"new_e{j}/d{d}"])


def test_grad_compress_matches_reference(mesh22, ref_dir):
    """4 compressed steps on 2x2 against the reference's: step 1's loss
    within 1e-5, each loss within 1e-4 relative (a later step's loss moves
    with parameters that an int8 rounding can move by ``lr``), parameters
    after 2 steps as the plain step's; the error buffers after 2 steps
    (the reference's ``ef_error``: the parameters' placement, each data
    shard's slice of its own buffer) within the single-device test's
    bounds (``tests/test_torch_train_step.py``: mean ``1e-2 * max``, max
    ``4 * max``), the replicated leaves each data rank's own."""
    ref = _ref(ref_dir, "compress")
    out = _outcome(mesh22, "compress")
    c = [l for l, _ in out["c"]]
    assert abs(c[0] - ref["c/loss"][0]) <= 1e-5
    np.testing.assert_allclose(c, ref["c/loss"], rtol=1e-4)
    for n, (mean, top) in out["param_diffs"].items():
        assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)
    for n, e in out["ef_full"].items():
        top = np.abs(ref[f"e/{n}"]).max()
        d = np.abs(e - ref[f"e/{n}"])
        assert d.mean() <= 1e-2 * top and d.max() <= 4 * top, n
    assert out["ef_own"]
    for r, res in enumerate(mesh22):
        own = res["compress"][1]["ef_own"]
        for n, e in own.items():
            want = ref[f"e/{n}/d{r // 2}"]
            top = np.abs(want).max()
            assert np.abs(e - want).mean() <= 1e-2 * top, (r, n)


def test_grad_compress_converges_like_uncompressed(mesh22):
    """``tests/test_runtime.py``'s checks on the port's 2x2 ranks: the
    first loss equal, both decreasing, the last within 0.5."""
    out = _outcome(mesh22, "compress")
    c, u = [l for l, _ in out["c"]], [l for l, _ in out["u"]]
    assert c[0] == u[0]
    assert c[-1] < c[0] and u[-1] < u[0]
    assert abs(c[-1] - u[-1]) < 0.5


def test_compressed_mean_is_the_ranks_codes_recounted(mesh22):
    """Step 1's mean gradient, leaf by leaf, recounted on the host from
    every rank's int8 codes and scales: the codes summed over the data
    ranks as int32, times the largest scale, over 2."""
    per_rank = [r["compress"][1]["codes"] for r in mesh22]
    for i in range(len(per_rank[0])):
        # ranks 0 and 2 hold data shards 0 and 1 on model column 0
        q = [per_rank[r][i][0] for r in (0, 2)]
        s = [per_rank[r][i][1] for r in (0, 2)]
        summed = q[0].to(torch.int32) + q[1].to(torch.int32)
        mean = summed.float() * torch.maximum(s[0], s[1]) / torch.tensor(2.0)
        for r in range(4):
            assert torch.equal(per_rank[r][i][2], mean), i


# -------------------------------------------------------------------------
# checkpoints: elastic re-mesh, across the packages, the supervisor
# -------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["2x1", "1x2", "1x1"])
def test_elastic_remesh(request, mesh22, ckpt_dir, shape):
    """The 2x2 checkpoint at step 2 restored onto another mesh (1x1: one
    device): leaves equal, and step 3 there equals the single-device
    ``microbatch = dp`` step 3 from the checkpoint and, on every mesh,
    2x2's own step 3."""
    saved = _outcome(mesh22, "save")
    if shape == "1x1":
        from repro_torch.train import (
            TrainConfig,
            init_train_state,
            restore_checkpoint,
        )

        cfg = _cfg("qwen3-0.6b")
        tcfg = TrainConfig(remat=False, seed=7)
        state, step = restore_checkpoint(ckpt_dir, init_train_state(
            cfg, tcfg, device="cpu"))
        assert step == 2 and _crcs(state) == saved["crcs"]
        _, want = _single(cfg, tcfg, state, 2, _batches(cfg, 3, start=2))
        assert want == saved["step3"]
        return
    out = _outcome(_mesh(request, shape), "restore")
    assert out["step"] == 2 and out["restored"] == saved["crcs"]
    assert out["metrics"] == out["single"] and out["crc_equal"]
    if shape == "2x1":
        assert out["metrics"] == saved["step3"]


def test_sharded_checkpoint_restored_by_reference(mesh22, ckpt_dir):
    """The port's 2x2 checkpoint read by the reference's restore into its
    own train state: every leaf's ``(shape, dtype, crc32)`` as written."""
    import zlib

    import jax
    from repro import configs as jconfigs
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import init_train_state as j_init
    from repro.train import restore_checkpoint as j_restore
    from repro.train.checkpoint import _to_storable

    saved = _outcome(mesh22, "save")
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    like = jax.eval_shape(lambda: j_init(cj, JTrainConfig(remat=False)))
    state, step = j_restore(ckpt_dir, like, step=2)
    got = []
    for leaf in jax.tree.leaves(state):
        stored, name = _to_storable(np.asarray(leaf))
        got.append((list(stored.shape), name, zlib.crc32(stored.tobytes())))
    assert step == 2 and got == [tuple(x) for x in saved["crcs"]]


def test_reference_checkpoint_restored_on_ranks(mesh22, ref_dir):
    """The reference's 2x2 checkpoint restored onto the port's 2x2 ranks:
    the gathered leaves are the files', and a step from them is the
    single-device ``microbatch=2`` step."""
    import json

    with open(os.path.join(ref_dir, "ckpt", "step_2", "manifest.json")) as f:
        files = [(m["shape"], m["dtype"], m["crc32"])
                 for m in json.load(f)["leaves"]]
    out = _outcome(mesh22, "ref_ckpt")
    assert out["step"] == 2 and out["restored"] == files
    assert out["metrics"] == out["single"] and out["crc_equal"]


def test_supervised_restart_on_two_ranks(mesh21):
    """Rank 1 fails once; both ranks restore and the end state is the
    uninterrupted run's, bit for bit."""
    out = _outcome(mesh21, "supervisor")
    assert out["failed"]["restarts"] == 1 and out["whole"]["restarts"] == 0
    assert out["failed"]["step"] == out["whole"]["step"] == 4
    assert out["failed"]["crcs"] == out["whole"]["crcs"]
    assert out["failed"]["losses"] == out["whole"]["losses"]
