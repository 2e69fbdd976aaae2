"""The partitioned tensor-parallel train step (``tp_mode="partitioned"``:
every family) on spawned CPU ranks joined over gloo, held against the
reference's GSPMD train step, against the port's plain functions and
against its own exact mode.

The reference runs once, in a subprocess with 4 forced host devices
(``tests/torch_mesh_train_reference.py partitioned``, ``Auto`` mesh axes),
on float32 smoke configs from ``PRNGKey(0)``: qwen3-0.6b (a gated
``w_in``, whose tp share the step exchanges into ``[gate_i | up_i]``),
nemotron-4-15b (relu2, no gate), deepseek-moe-16b (routed experts as
exact mode splits them, shared experts on tp shares), phi-3-vision-4.2b
(the patch prefix; the reference's seeded patches read from its file),
rwkv6-3b (RWKV6 on each rank's heads), recurrentgemma-9b (the recurrent
block on each rank's channels, the local attention's one KV head whole)
and whisper-small (the encoder, the cross-attention; the reference's
seeded frames read from its file), two steps on 1x2 and 2x2 with and
without ``grad_compress``; and whisper-small with an odd vocabulary of 257
on 1x2 (``embed`` and ``lm_head`` whole, the whole-head loss).  Its
compressed step raises under this jax on qwen3, phi-3-vision,
recurrentgemma and whisper at 1x2 and on the other three everywhere (the
reference script records the errors); there the partitioned compressed
step is held to the same bounds against the port's exact-mode compressed
step on the same mesh, which ``test_torch_train_sharded.py`` holds
against the reference and the single-device step.  Bounds against the reference are
``test_torch_train_sharded.py``'s: step 1's loss within ``1e-5``, each
gradient norm within ``1e-4`` relative, every parameter after 2 steps
within ``2e-3`` (a leaf's mean difference within ``1e-3 * lr``).

Each mesh shape (1x2, 2x2, 1x4) starts its ranks once and runs every
scenario of that shape in them; a test reads its scenario's outcome.
"""
import contextlib
import dataclasses
import math
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
ARCHS = ("qwen3-0.6b", "nemotron-4-15b", "deepseek-moe-16b",
         "phi-3-vision-4.2b", "rwkv6-3b", "recurrentgemma-9b",
         "whisper-small")
# where the reference's compressed step runs under this jax (elsewhere it
# raises and the case is held against exact mode, module docstring)
REF_COMPRESS_RUNS = {("qwen3-0.6b", "2x2"), ("phi-3-vision-4.2b", "2x2"),
                     ("recurrentgemma-9b", "2x2"), ("whisper-small", "2x2")}
# whisper-small's smoke config with an odd vocabulary (the published 51865
# is odd), as ``tests/torch_mesh_train_reference.py`` names it
ODD = "whisper-small-odd"
VARIANTS = {ODD: ("whisper-small", {"vocab_size": 257})}
SHAPES = ("1x2", "2x2")
LR = 1e-3


# -------------------------------------------------------------------------
# what the ranks run (importable: the ranks are spawned)
# -------------------------------------------------------------------------
def _ref(ref_dir, arch):
    return np.load(os.path.join(ref_dir, f"part_{arch}.npz"))


def _part_cfg(arch):
    """``_cfg``, a variant of :data:`VARIANTS` with its override."""
    arch, over = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(_cfg(arch), **over)


def _state(arch, ref_dir, **kw):
    """A fresh single-device state on the reference's initial
    parameters."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.train import TrainConfig
    from repro_torch.train.state import state_for

    cfg = _part_cfg(arch)
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


def _part_batches(cfg, ref, n):
    """``_batches``, vlm's with the reference's patches of each step,
    encdec's with its frames."""
    batches = _batches(cfg, n)
    extra = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
    if extra:
        for i, b in enumerate(batches):
            b[extra] = ref[f"{extra}/{i}"]
    return batches


class _WKVHeads:
    """Record the head count of every ``ops.wkv`` call (K8 on the card,
    its plain version here)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.orig, self.heads = ops.wkv, []
        orig, heads = self.orig, self.heads

        def spy(q, *a, **kw):
            heads.append(q.shape[2])
            return orig(q, *a, **kw)

        ops.wkv = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.wkv = self.orig


class _Calls:
    """Record the calls of ``module.name`` (what the first argument's
    shape is): the vocab-parallel cross-entropy as the losses call it,
    the RG-LRU's scan."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __enter__(self):
        import importlib

        self.mod = importlib.import_module(self.module)
        self.orig, self.shapes = getattr(self.mod, self.name), []
        orig, shapes = self.orig, self.shapes

        def spy(x, *a, **kw):
            shapes.append(tuple(x.shape))
            return orig(x, *a, **kw)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


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
    from repro_torch.nn.sharding import TP_AXIS
    from repro_torch.nn.transformer import tp_shares
    from repro_torch.train import (
        TrainConfig,
        shard_train_state,
        train_state_shardings,
    )
    from repro_torch.train.step import _is_expert

    key = ("c/" if compress else "") + "x".join(
        str(mesh.shape[a]) for a in ("data", "model"))
    ref = _ref(ref_dir, arch)
    out = {"ref_error": (str(ref[f"{key}/error"])
                         if f"{key}/error" in ref.files else None)}
    # the leaves split at rest that the partitioned compute takes whole
    cfg = _part_cfg(arch)
    pl = train_state_shardings(cfg, TrainConfig(), mesh)["params"]
    split = tp_shares(cfg, pl, mesh).split
    out["fallback"] = [(n, tuple(p.spec)) for n, p in pl.items()
                       if not p.only((TP_AXIS,)).replicated
                       and n not in split and not _is_expert(n)]
    for mode in ("partitioned", "exact"):
        cfg, tcfg, full = _state(arch, ref_dir, grad_compress=compress)
        sh = train_state_shardings(cfg, tcfg, mesh)
        state = shard_train_state(full, cfg, mesh)
        with _GatherSpy() as spy, _WKVHeads() as heads, _Calls(
                "repro_torch.nn.transformer",
                "vocab_parallel_cross_entropy") as ce, _Calls(
                "repro_torch.nn.rglru", "_lru_scan") as scans:
            state, got, timings = _run(mesh, cfg, tcfg, state,
                                       _part_batches(cfg, ref, 2), mode)
        out[mode] = {"metrics": got, "timings": timings,
                     "whole_gathered": spy.whole, "wkv_heads": heads.heads,
                     "vocab_parallel_ce": len(ce.shapes),
                     "scan_channels": sorted({sh[-1] for sh in
                                              scans.shapes}),
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
    first and last vocab entries among them), the gated ``w_in``
    exchange against slicing the whole leaf, both ways,
    ``gather_from_tp`` against the whole tensor forward and its slice of
    the gradient backward, and ``gather_to_tp`` into a rank's columns of
    a product against autograd of the unsplit product (the input's
    gradient summed over the ranks' columns, then sliced)."""
    from repro_torch.nn.layers import (
        embed_lookup,
        embed_lookup_tp,
        softmax_cross_entropy,
    )
    from repro_torch.nn.sharding import (
        TP_AXIS,
        gate_up_exchange,
        gather_from_tp,
        gather_to_tp,
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
        whole = torch.from_numpy(rng.normal(size=(2, 5, 3 * n)).astype(
            np.float32))
        local = whole[..., 3 * i:3 * (i + 1)].clone().requires_grad_(True)
        joined = gather_from_tp(local)
        w = torch.from_numpy(rng.normal(size=(2, 5, 3 * n)).astype(
            np.float32))
        (joined * w).sum().backward()
        out["gather"] = torch.equal(joined, whole)
        out["gather_grad"] = torch.equal(local.grad,
                                         w[..., 3 * i:3 * (i + 1)])
        # y = u @ W on the whole u, the rank's columns of W on its share
        u = torch.from_numpy(rng.normal(size=(2, 5, 3 * n)).astype(
            np.float64)).requires_grad_(True)
        wt = torch.from_numpy(rng.normal(size=(3 * n, 2 * n)))
        up = torch.from_numpy(rng.normal(size=(2, 5, 2 * n)))
        (torch.matmul(u, wt) * up).sum().backward()
        mine = u.detach()[..., 3 * i:3 * (i + 1)].clone().requires_grad_(True)
        cols = slice(2 * i, 2 * (i + 1))
        joined = gather_to_tp(mine)
        (torch.matmul(joined, wt[:, cols]) * up[..., cols]).sum().backward()
        out["gather_to"] = torch.equal(joined, u.detach())
        out["gather_to_grad"] = float((mine.grad - u.grad[
            ..., 3 * i:3 * (i + 1)]).abs().max())
    return out


def sc_shared_exchange(mesh, ref_dir):
    """deepseek-moe-16b's ``blocks.sh_w_in``: the rank's share as the
    partitioned step holds it (gathered over the data axes only, the model
    axis kept) exchanged into the compute's layout, against ``[gate_i |
    up_i]`` sliced from the whole leaf; and the leaves the step splits."""
    from repro_torch.nn.sharding import TP_AXIS, gate_up_exchange
    from repro_torch.nn.transformer import tp_shares
    from repro_torch.train import shard_train_state, train_state_shardings

    cfg, tcfg, full = _state("deepseek-moe-16b", ref_dir)
    pl = train_state_shardings(cfg, tcfg, mesh)["params"]
    state = shard_train_state(full, cfg, mesh)
    name = "blocks.sh_w_in"
    share = dict(state["params"].named_parameters())[name].detach()
    compute = gate_up_exchange(pl[name].gather(share, keep=(TP_AXIS,)),
                               mesh)
    whole = dict(full["params"].named_parameters())[name].detach()
    n, i = mesh.shape[TP_AXIS], mesh.index(TP_AXIS)
    f = whole.shape[-1] // 2
    s = f // n
    want = torch.cat([whole[..., i * s:(i + 1) * s],
                      whole[..., f + i * s:f + (i + 1) * s]], dim=-1)
    tp = tp_shares(cfg, pl, mesh)
    return {"exchange": torch.equal(compute, want),
            "split": sorted(tp.split), "gate_up": sorted(tp.gate_up)}


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
            for a in ARCHS for c in (False, True)] + [
        ("ops", sc_ops, {}),
        ("shared", sc_shared_exchange, {"ref_dir": ref_dir})]


@pytest.fixture(scope="module")
def mesh22(ref_dir, ckpt_dir):
    return _spawn(2, 2, _steps(ref_dir) + [
        ("save", sc_save, {"ref_dir": ref_dir, "ckpt_dir": ckpt_dir})])


@pytest.fixture(scope="module")
def mesh12(ref_dir):
    return _spawn(1, 2, _steps(ref_dir) + [
        ("launcher", sc_launcher, {}),
        (f"steps-{ODD}-False", sc_steps,
         {"arch": ODD, "ref_dir": ref_dir, "compress": False})])


@pytest.fixture(scope="module")
def mesh14(ref_dir, ckpt_dir, mesh22):
    return _spawn(1, 4, [("ops", sc_ops, {}),
                         ("shared", sc_shared_exchange, {"ref_dir": ref_dir}),
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
        assert compress and (arch, shape) not in REF_COMPRESS_RUNS, \
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
    """No gather of the partitioned steps puts a leaf the step keeps split
    over the model axis back together whole over it (exact mode's steps
    do, for every leaf split at rest); only a leaf split at rest that the
    compute takes whole (the reference's divisibility fallback:
    recurrentgemma-9b's one KV head, ``wk`` / ``wv``, and nothing of the
    other families) is gathered, once a step (and its error buffer once a
    compressed step); the step's timings keep exact mode's four keys."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}-{compress}")
    fallback = [spec for _, spec in out["fallback"]]
    assert sorted(out["partitioned"]["whole_gathered"]) == sorted(
        fallback * 2 * (1 + compress))
    assert [n for n, _ in out["fallback"]] == (
        ["groups.t2_attn.wk", "groups.t2_attn.wv"]
        if arch == "recurrentgemma-9b" else [])
    assert out["exact"]["whole_gathered"]
    assert out["partitioned"]["timings"] == out["exact"]["timings"] == [
        "forward_backward_s", "gather_s", "reduce_s", "update_s"]


# rwkv6-3b's step-2 gradient norm is held at the reference's bound (1e-4
# relative): AdamW's first step moves a weight whose gradient is rounding
# noise by +-lr either way, and there the port's exact mode is itself
# 4e-5 from the reference's GSPMD step (32.66303 against 32.66437)
NEAR_EXACT_STEP2_NORM = {"rwkv6-3b": 1e-4}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_step_near_exact_mode(request, shape, arch):
    """The two modes compute the same sums associated otherwise (the
    row-parallel products' partial sums, the vocab-split log-sum-exp):
    losses and norms within 1e-5 relative (rwkv6-3b's second norm
    within ``NEAR_EXACT_STEP2_NORM``), parameters after 2 steps as
    against the reference."""
    out = _outcome(_mesh(request, shape), f"steps-{arch}-False")
    for j, ((l, g), (wl, wg)) in enumerate(zip(out["partitioned"]["metrics"],
                                               out["exact"]["metrics"])):
        rtol = NEAR_EXACT_STEP2_NORM.get(arch, 1e-5) if j else 1e-5
        assert abs(l - wl) <= 1e-5 * wl and abs(g - wg) <= rtol * wg
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


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_gather_from_tp_is_slicing_the_whole_tensor(request, shape):
    """On every rank ``gather_from_tp`` of the rank's columns is the whole
    tensor bit for bit, and its backward the rank's columns of the whole
    gradient bit for bit."""
    for r, res in enumerate(_mesh(request, shape)):
        status, out = res["ops"]
        assert status == "ok", out
        assert out["gather"] and out["gather_grad"], r


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_gather_to_tp_sums_the_gradient_before_the_slice(request, shape):
    """On every rank ``gather_to_tp`` of the rank's columns is the whole
    tensor bit for bit, and fed to the rank's columns of a product its
    backward is the rank's columns of the whole input's gradient (autograd
    of the unsplit product, float64, within 1e-12): the ranks' partial
    gradients summed, where a slice alone would miss every other rank's
    columns."""
    for r, res in enumerate(_mesh(request, shape)):
        status, out = res["ops"]
        assert status == "ok", out
        assert out["gather_to"], r
        assert out["gather_to_grad"] <= 1e-12, (r, out["gather_to_grad"])


@pytest.mark.parametrize("shape", ["1x2", "2x2", "1x4"])
def test_shared_expert_exchange_is_slicing_the_whole_leaf(request, shape):
    """deepseek-moe-16b: every rank's ``sh_w_in`` share as the step holds
    it, exchanged, is ``[gate_i | up_i]`` of the whole leaf bit for bit;
    the step splits the shared experts (``sh_w_in`` in the gated layout),
    the attention and the vocabulary, and leaves the router and the
    routed expert stacks to exact mode's handling."""
    for r, res in enumerate(_mesh(request, shape)):
        status, out = res["shared"]
        assert status == "ok", out
        assert out["exchange"], r
        assert out["gate_up"] == ["blocks.sh_w_in"]
        assert set(out["split"]) == {
            "embed", "lm_head", "blocks.wq", "blocks.wo", "blocks.sh_w_in",
            "blocks.sh_w_out"} | ({"blocks.wk", "blocks.wv"}
                                  if shape != "1x4" else set())


@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_rwkv_runs_the_wkv_on_the_ranks_heads(request, shape):
    """rwkv6-3b: every WKV call of the partitioned steps (``ops.wkv``: K8
    on the card) takes ``H / tp`` heads, exact mode's ``H``; one call a
    layer a step."""
    from test_torch_train_sharded import _cfg as cfg_of

    cfg = cfg_of("rwkv6-3b")
    heads = cfg.d_model // cfg.rwkv_head_dim
    out = _outcome(_mesh(request, shape), "steps-rwkv6-3b-False")
    n = 2 * cfg.n_layers
    assert out["partitioned"]["wkv_heads"] == [heads // 2] * n
    assert out["exact"]["wkv_heads"] == [heads] * n


@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_hybrid_runs_the_scan_on_the_ranks_channels(request,
                                                                shape):
    """recurrentgemma-9b: every RG-LRU scan of the partitioned steps runs
    on ``d_rnn / tp`` channels, exact mode's on ``d_rnn``; whisper-small
    and the hybrid's even vocabulary take the vocab-parallel loss in the
    partitioned steps only."""
    from test_torch_train_sharded import _cfg as cfg_of

    d_rnn = cfg_of("recurrentgemma-9b").d_rnn
    out = _outcome(_mesh(request, shape), "steps-recurrentgemma-9b-False")
    assert out["partitioned"]["scan_channels"] == [d_rnn // 2]
    assert out["exact"]["scan_channels"] == [d_rnn]
    for arch in ("recurrentgemma-9b", "whisper-small"):
        out = _outcome(_mesh(request, shape), f"steps-{arch}-False")
        assert out["partitioned"]["vocab_parallel_ce"] == 2
        assert out["exact"]["vocab_parallel_ce"] == 0


def test_odd_vocabulary_takes_the_whole_head(mesh12):
    """whisper-small with an odd vocabulary (257; the published 51865 is
    odd too) on 1x2: ``embed`` and ``lm_head`` stay whole, the loss takes
    the whole-head route (no vocab-parallel cross-entropy), and the step
    is within the bounds of :func:`test_partitioned_step_matches_reference`
    of the reference's GSPMD step and of the port's exact mode."""
    out = _outcome(mesh12, f"steps-{ODD}-False")
    assert out["ref_error"] is None
    part = out["partitioned"]
    assert part["vocab_parallel_ce"] == 0 and part["whole_gathered"] == []
    for want, diffs in ((list(zip(out["ref"]["loss"],
                                  out["ref"]["grad_norm"])),
                         out["ref"]["param_diffs"]),
                        (out["exact"]["metrics"], out["exact_diffs"])):
        got = part["metrics"]
        assert abs(got[0][0] - want[0][0]) <= 1e-5
        for (_, g), (_, r) in zip(got, want):
            assert abs(g - r) <= 1e-4 * r, (g, r)
        for n, (mean, top) in diffs.items():
            assert top <= 2e-3 and mean <= 1e-3 * LR, (n, mean, top)


def test_odd_vocabulary_leaves_the_head_whole():
    """``tp_shares`` splits whisper-small's embedding and head at its
    smoke vocabulary (256) and leaves them whole at an odd one, at the
    published widths' 51865 too, on 1x2 and 1x4; the attention, the
    cross-attention and the MLPs split either way."""
    from repro_torch.configs import get_config
    from repro_torch.nn.sharding import Mesh
    from repro_torch.nn.transformer import tp_shares
    from repro_torch.train import TrainConfig, train_state_shardings

    for tp in (2, 4):
        mesh = Mesh(("data", "model"), (1, tp), rank=0)
        for cfg, whole in ((_part_cfg("whisper-small"), False),
                           (_part_cfg(ODD), True),
                           (get_config("whisper-small"), True)):
            pl = train_state_shardings(cfg, TrainConfig(), mesh)["params"]
            split = tp_shares(cfg, pl, mesh).split
            assert ({"embed", "lm_head"} & split == set()) == whole
            assert {"enc_blocks.wq", "dec_blocks.xwq", "dec_blocks.xwo",
                    "enc_blocks.w_in", "dec_blocks.w_out"} <= split


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
    """A mode but the two raises; so does ``"partitioned"`` with LUT
    tables, or ``tp_shares`` on a family that does not exist (naming it),
    while every family takes it; the launcher refuses another mode with
    status 2."""
    from repro_torch.launch import train as tl
    from repro_torch.nn.sharding import Mesh
    from repro_torch.nn.transformer import TP_FAMILIES, tp_shares
    from repro_torch.train import TrainConfig, make_train_step

    tcfg = TrainConfig(remat=False)
    with pytest.raises(ValueError, match="tp_mode 'bogus'"):
        make_train_step(_cfg("qwen3-0.6b"), tcfg, "cpu", tp_mode="bogus")
    archs = ("deepseek-moe-16b", "phi-3-vision-4.2b", "rwkv6-3b",
             "recurrentgemma-9b", "whisper-small")
    assert {_cfg(a).family for a in archs + ("qwen3-0.6b",)} == set(
        TP_FAMILIES)
    for arch in archs:
        assert callable(make_train_step(_cfg(arch), tcfg, "cpu",
                                        tp_mode="partitioned"))
    with pytest.raises(ValueError, match="family 'bogus'"):
        tp_shares(dataclasses.replace(_cfg("qwen3-0.6b"), family="bogus"),
                  {}, Mesh(("data", "model"), (1, 2), rank=0))
    with pytest.raises(ValueError, match="no LUT tables"):
        make_train_step(_cfg("qwen3-0.6b"), tcfg, "cpu",
                        lut_tables={"backend": "gather"},
                        tp_mode="partitioned")
    with pytest.raises(SystemExit) as e:
        tl.parse_args(["--tp-mode", "bogus"])
    assert e.value.code == 2


class _Products:
    """Record every ``mm`` / ``bmm`` the cost counter of a trace sees:
    ``(op, operand shapes, FLOPs)``."""

    def __enter__(self):
        from repro_torch.roofline import costs

        self.orig = orig = costs._Counter.__torch_dispatch__
        calls = self.calls = []

        def spy(mode, func, types, args=(), kwargs=None):
            out = orig(mode, func, types, args, kwargs)
            op = str(func._overloadpacket)
            if op in ("aten.mm", "aten.bmm"):
                a, b = args[0].shape, args[1].shape
                calls.append((op, [tuple(a), tuple(b)],
                              2 * math.prod(a) * b[-1]))
            return out

        costs._Counter.__torch_dispatch__ = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.roofline import costs

        costs._Counter.__torch_dispatch__ = self.orig


def _trace(tp_mode, arch="qwen3-0.6b", products=None):
    from repro_torch.launch.dryrun import fake_group, trace_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(_cfg(arch), dtype="bfloat16")
    with fake_group(2), (products or contextlib.nullcontext()):
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


def test_dryrun_partitioned_rwkv_halves_the_split_products():
    """rwkv6-3b, one 1x2 rank's step traced on the meta device: the
    products of the split weights (``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` /
    ``w_o``, ``w_ffn_k`` / ``w_ffn_v`` / ``w_ffn_r``, the rank's columns of
    ``decay_b``, ``lm_head``; each a forward and two backward ``mm``)
    count half an exact rank's FLOPs and every other product the same;
    the WKV kernel points launch as often."""
    from test_torch_train_sharded import _cfg as cfg_of

    cfg = cfg_of("rwkv6-3b")
    d, ff, bt = cfg.d_model, cfg.d_ff, 4 * 16
    weights = cfg.n_layers * (6 * d * d + 2 * d * ff + 64 * d) \
        + d * cfg.vocab_size
    split_flops = 3 * 2 * bt * weights
    exact, part = _trace("exact", "rwkv6-3b"), _trace("partitioned",
                                                       "rwkv6-3b")
    assert exact.per_comp_flops["aten.mm"] - part.per_comp_flops[
        "aten.mm"] == split_flops // 2
    assert part.launches == exact.launches and part.launches
    assert "all-gather" in part.per_op_coll      # the gate's columns


def test_dryrun_partitioned_moe_keeps_the_expert_products():
    """deepseek-moe-16b, one 1x2 rank's step traced on the meta device:
    the expert products (the ``bmm`` over the rank's experts' capacity
    slots) are an exact rank's, call for call; the rank's other products
    count fewer FLOPs (attention, shared experts and head split)."""
    from repro_torch.nn.moe import moe_capacity
    from test_torch_train_sharded import _cfg as cfg_of

    cap = moe_capacity(4 * 16, cfg_of("deepseek-moe-16b").moe)
    runs = {}
    for mode in ("exact", "partitioned"):
        with _Products() as rec:
            _trace(mode, "deepseek-moe-16b", products=rec)
        experts = sorted(c for c in rec.calls if c[0] == "aten.bmm"
                         and any(cap in sh for sh in c[1]))
        runs[mode] = (experts, sum(c[2] for c in rec.calls
                                   if c not in experts))
    assert runs["exact"][0] and runs["partitioned"][0] == runs["exact"][0]
    assert runs["partitioned"][1] < runs["exact"][1]


def test_dryrun_partitioned_hybrid_and_encdec_halve_the_split_products():
    """One 1x2 rank's step traced on the meta device, for the two
    families this mode reached last.  whisper-small: every product is
    split (the encoder's and the decoder's attention and MLP, the
    cross-attention, the head), so the rank's ``mm`` and ``bmm`` FLOPs are
    half an exact rank's.  recurrentgemma-9b: the products of the split
    weights (the recurrent block's ``w_in`` / ``w_gate`` / ``w_a`` /
    ``w_x`` / ``w_out``, the local attention's ``wq`` / ``wo``, the MLPs,
    ``lm_head``; each a forward and two backward ``mm``) count half an
    exact rank's FLOPs, the one KV head's products the same; the
    attention's ``bmm`` half."""
    from test_torch_train_sharded import _cfg as cfg_of

    exact, part = _trace("exact", "whisper-small"), _trace(
        "partitioned", "whisper-small")
    for op in ("aten.mm", "aten.bmm"):
        assert part.per_comp_flops[op] * 2 == exact.per_comp_flops[op], op
    assert "all-gather" not in part.per_op_coll

    cfg = cfg_of("recurrentgemma-9b")
    d, r, ff, bt = cfg.d_model, cfg.d_rnn, cfg.d_ff, 4 * 16
    rec, attn = 3 * d * r + 2 * r * r, 2 * d * cfg.n_heads * cfg.d_head
    mlp = 3 * d * ff                    # geglu: [gate|up] and w_out
    n_rec = cfg.n_layers - cfg.n_layers // 3
    weights = n_rec * rec + (cfg.n_layers - n_rec) * attn \
        + cfg.n_layers * mlp + d * cfg.vocab_size
    exact, part = _trace("exact", "recurrentgemma-9b"), _trace(
        "partitioned", "recurrentgemma-9b")
    assert exact.per_comp_flops["aten.mm"] - part.per_comp_flops[
        "aten.mm"] == 3 * 2 * bt * weights // 2
    assert part.per_comp_flops["aten.bmm"] * 2 == \
        exact.per_comp_flops["aten.bmm"]
    assert part.per_op_coll.get("all-gather", 0) > 0   # the conv output
