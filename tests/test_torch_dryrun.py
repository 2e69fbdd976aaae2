"""The port's dry run (``repro_torch.launch.dryrun``), its abstract state,
the kernels' abstract route, the hill climb's levers and
``launch.hillclimb`` against the reference on the CPU, on smoke configs.

Tolerances:
* the fast stream (bf16 inputs, each package under its own switch, the
  reference run op by op): ``rms_norm``, ``apply_rope`` and
  ``decode_attend`` within one bf16 step (``rtol 2**-7``) of the
  reference's, where float32 sums in another order may round the other
  way; the smoke model's training loss within ``FAST_LOSS_RTOL`` (1e-2
  relative) of the reference's and of its own float32-stream loss (a
  bf16 stream rounds every norm and rotation once more; the card's phase
  24 (d) holds the full-width step to the same bound);
* ``wkv_chunked``'s plain form at chunks 16, 8 and 4 within 1e-4 of the
  reference under its ``set_wkv_chunk`` (float32, the same sums in
  chunks of another length);
* the dry run's peak within 1% of ``MemTracker``'s on a real CPU run of
  the same step, and its counts (FLOPs, bytes, operations) equal to the
  real run's: tensors without data run the same operations on the same
  shapes and strides.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import SHAPES, dryrun_cell, trace_step
from repro_torch.roofline.costs import count_costs

FAST_LOSS_RTOL = 1e-2
BF16_RTOL = 2.0 ** -7


def _cfgs(arch, dtype="float32"):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype=dtype)
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype=dtype)
    return cj, ct


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tdtype(jdt) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[str(jdt)]


# -------------------------------------------------------------------------
# abstract state
# -------------------------------------------------------------------------
@pytest.mark.parametrize("arch,dtype,compress", [
    ("qwen3-0.6b", "bfloat16", False), ("qwen3-0.6b", "float32", True),
    ("rwkv6-3b", "bfloat16", False), ("deepseek-moe-16b", "bfloat16", True),
    ("recurrentgemma-9b", "bfloat16", False),
    ("whisper-small", "bfloat16", False)])
def test_abstract_train_state_matches_reference_eval_shape(arch, dtype,
                                                           compress):
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import abstract_train_state as j_abstract
    from repro_torch.train import TrainConfig, abstract_train_state

    cj, ct = _cfgs(arch, dtype)
    js = j_abstract(cj, JTrainConfig(grad_compress=compress))
    ts = abstract_train_state(ct, TrainConfig(grad_compress=compress),
                              device="meta")
    assert set(ts) == set(js)
    jp = _flat(js["params"])
    named = list(ts["params"].named_parameters())
    assert sorted(n for n, _ in named) == sorted(jp)   # jax sorts keys
    for (n, p), mu, nu in zip(named, ts["opt"]["mu"], ts["opt"]["nu"]):
        assert p.device.type == "meta"
        assert (tuple(p.shape), p.dtype) == (jp[n].shape, _tdtype(jp[n].dtype))
        for m, ref in ((mu, _flat(js["opt"]["mu"])[n]),
                       (nu, _flat(js["opt"]["nu"])[n])):
            assert (tuple(m.shape), m.dtype) == (ref.shape,
                                                 _tdtype(ref.dtype))
    assert js["step"].shape == () and ts["step"] == 0
    assert js["opt"]["count"].shape == () and ts["opt"]["count"] == 0
    if compress:
        je = _flat(js["ef_error"])
        for (n, _), e in zip(named, ts["ef_error"]):
            assert (tuple(e.shape), e.dtype) == (je[n].shape, torch.float32)


def test_abstract_train_state_on_a_mesh_holds_a_ranks_shares():
    from repro_torch.nn.sharding import Mesh
    from repro_torch.train import TrainConfig, abstract_train_state
    from repro_torch.train.state import train_param_shardings

    _, ct = _cfgs("qwen3-0.6b", "bfloat16")
    mesh = Mesh(("data", "model"), (2, 2), rank=3)
    ts = abstract_train_state(ct, TrainConfig(), device="meta", mesh=mesh)
    pl = train_param_shardings(ct, mesh)
    full = dict(abstract_train_state(ct, TrainConfig(), device="meta")[
        "params"].named_parameters())
    for n, p in ts["params"].named_parameters():
        assert tuple(p.shape) == pl[n].local_shape(tuple(full[n].shape))
    assert any(tuple(p.shape) != tuple(full[n].shape)
               for n, p in ts["params"].named_parameters())


# -------------------------------------------------------------------------
# the kernels' abstract route
# -------------------------------------------------------------------------
def _meta_entry():
    from repro_torch.serve import build_serving_plans

    _, ct = _cfgs("qwen3-0.6b")
    plans = build_serving_plans(ct, np.random.default_rng(0).normal(
        size=20000) * 3)
    with ops.abstract():
        return plans.tables_for_model(backend="cuda", device="meta")


def test_fake_tensor_outside_abstract_raises():
    """A wrapper given a tensor with no data outside ``ops.abstract()``
    goes to the kernel, which cannot take it: it raises, nothing falls
    back."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    entry = _meta_entry()["sites"]["mlp"]
    pa = ops.PlanArrays(kind="decomposed", **{
        k: entry["meta"][k] for k in ("w_in", "w_out", "l", "w_lb", "w_hb")},
        arrays=entry["arrays"], pack=entry["meta"].get("pack"))
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError, match="no data"):
        ops.lut_act(x, pa, x_lo=-8.0, x_hi=8.0, y_lo=0.0, y_hi=1.0,
                    record=entry["k1_record"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fused_matmul_lut(x, torch.empty((64, 32), device="meta"), entry,
                             gated=True)
    q = torch.empty((1, 32, 2, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.wkv(q, q, q, q, torch.empty((2, 64), device="meta"), chunk=16)
    with FakeTensorMode():
        xf = torch.empty((4, 64), device="cuda:0")
        with pytest.raises(ValueError, match="no data"):
            ops.lut_act(xf, pa, x_lo=-8.0, x_hi=8.0, y_lo=0.0, y_hi=1.0,
                        record=entry["k1_record"])
        qf = torch.empty((1, 32, 2, 64), device="cuda:0")
        with pytest.raises(ValueError, match="no data"):
            ops.wkv(qf, qf, qf, qf, torch.empty((2, 64), device="cuda:0"),
                    chunk=16)
        with pytest.raises(ValueError, match="no data"):
            ops.wkv_backward(qf, qf, qf, qf,
                             torch.empty((2, 64), device="cuda:0"), qf)


def test_abstract_route_still_refuses_what_the_kernels_refuse():
    """K8's and K8b's plans run inside ``ops.abstract()``: a head size the
    kernels cannot take raises there as on the card."""
    q = torch.empty((1, 64, 2, 24), device="meta")
    u = torch.empty((2, 24), device="meta")
    with ops.abstract(), pytest.raises(ValueError, match="K8"):
        ops.wkv(q, q, q, q, u, chunk=16)
    q = torch.empty((1, 64, 2, 48), device="meta")
    u = torch.empty((2, 48), device="meta")
    with ops.abstract():
        y, s = ops.wkv(q, q, q, q, u, chunk=16)   # K8 takes N = 48
        assert y.shape == (1, 64, 2, 48) and s.shape == (1, 2, 48, 48)
        with pytest.raises(ValueError):
            ops.wkv_backward(q, q, q, q, u, q)    # K8b does not


def test_wkv_abstract_route_prices_k8_and_k8b():
    q = torch.empty((2, 64, 4, 64), device="meta", requires_grad=True)
    u = torch.empty((4, 64), device="meta", requires_grad=True)
    with ops.abstract(), count_costs("meta") as c:
        y, _ = ops.wkv(q, q, q, q, u, chunk=64)
        torch.autograd.grad(y.sum(), [q, u])
    assert c.launches == {"cuda:wkv": 1, "cuda:wkv_backward": 1}
    n = q.numel() * 4
    assert c.per_comp_hbm["cuda:wkv"] == 5 * n + 4 * 64 * 4 + 2 * 4 * 64 * \
        64 * 4
    # dy of a sum is a broadcast: made contiguous before K8b reads it
    assert c.per_comp_hbm["cuda:wkv_backward"] == 9 * n + 2 * u.numel() * 4


# -------------------------------------------------------------------------
# counts and memory against a real CPU run of the same step
# -------------------------------------------------------------------------
def _real_batch(ct, b, t):
    from repro_torch.train.step import input_batch_specs

    rng = np.random.default_rng(0)
    return {k: (torch.zeros(s) if np.dtype(d).kind == "f" else
                torch.from_numpy(rng.integers(0, ct.vocab_size, s)))
            for k, (s, d) in input_batch_specs(ct, b, t).items()}


def _real_step(ct, kind, b, t, tcfg):
    """One real CPU step under the counter and ``MemTracker``: ``(costs,
    peak)``, the state and inputs tracked as the dry run tracks them."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.dryrun import _tensors
    from repro_torch.nn import init_params
    from repro_torch.serve import decode_step, init_cache
    from repro_torch.train import init_train_state, make_train_step

    if kind == "train":
        state = init_train_state(ct, tcfg, device="cpu")
        batch = _real_batch(ct, b, t)
        step = make_train_step(ct, tcfg, device="cpu")
        rest, run = (state, batch), lambda: step(state, batch)
    else:
        params = init_params(ct, 0, "cpu")
        cache = init_cache(ct, b, t, device="cpu")
        tok = torch.zeros((b, 1), dtype=torch.long)
        pos = torch.tensor(t - 1)
        rest = (params, (cache, tok, pos), None)
        run = lambda: decode_step(params, ct, cache, tok, pos)
    mt = MemTracker()
    mt.track_external(*_tensors(rest))
    with mt, count_costs("cpu") as c:
        run()
    return c, mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]


@pytest.mark.parametrize("arch,kind,remat", [
    ("qwen3-0.6b", "train", False), ("qwen3-0.6b", "train", True),
    ("qwen3-0.6b", "decode", None), ("deepseek-moe-16b", "train", True),
    ("recurrentgemma-9b", "decode", None), ("whisper-small", "train", True),
    ("phi-3-vision-4.2b", "decode", None)])
def test_meta_trace_equals_real_cpu_step(arch, kind, remat):
    """The card's program traced on the meta device counts what the same
    step counts on real CPU tensors, operation for operation, where no
    hand-written kernel runs (the CPU runs the plain versions), and its
    peak is within 1% of ``MemTracker``'s on the real run."""
    from repro_torch.train import TrainConfig

    _, ct = _cfgs(arch)
    tcfg = TrainConfig(remat=bool(remat))
    b, t = (2, 16) if kind == "train" else (4, 24)
    tr = trace_step(ct, kind, b, t, tcfg=tcfg, device="meta")
    real, real_peak = _real_step(ct, kind, b, t, tcfg)
    fake = tr["costs"]
    assert fake.per_comp_hbm == real.per_comp_hbm
    assert (fake.flops, fake.hbm_bytes, fake.n_ops) == (
        real.flops, real.hbm_bytes, real.n_ops)
    assert abs(tr["peak_bytes"] - real_peak) <= 0.01 * real_peak, (
        tr["peak_bytes"], real_peak)


def test_fake_cpu_trace_equals_real_cpu_step_with_the_plain_wkv():
    """The CPU's program (plain K8 / K8b) traced on fake CPU tensors counts
    what the real CPU step counts; its peak within 1%."""
    from repro_torch.train import TrainConfig

    from torch._subclasses.fake_tensor import FakeTensorMode

    _, ct = _cfgs("rwkv6-3b")
    tcfg = TrainConfig(remat=True)
    with FakeTensorMode(allow_non_fake_inputs=True):
        tr = trace_step(ct, "train", 2, 16, tcfg=tcfg, device="cpu")
    real, real_peak = _real_step(ct, "train", 2, 16, tcfg)
    fake = tr["costs"]
    assert (fake.flops, fake.hbm_bytes, fake.n_ops) == (
        real.flops, real.hbm_bytes, real.n_ops)
    assert fake.launches == real.launches == {}
    assert abs(tr["peak_bytes"] - real_peak) <= 0.01 * real_peak


def test_meta_trace_counts_equal_a_fake_mode_trace():
    """Traced inside a ``FakeTensorMode`` the meta trace counts the same
    (the dry run takes the fake mode in force)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train import TrainConfig

    _, ct = _cfgs("rwkv6-3b", "bfloat16")
    a = trace_step(ct, "train", 2, 32, tcfg=TrainConfig(), device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True):
        b = trace_step(ct, "train", 2, 32, tcfg=TrainConfig(), device="meta")
    assert a["costs"].as_dict() == b["costs"].as_dict()
    assert a["peak_bytes"] == b["peak_bytes"]
    assert a["costs"].launches == {"cuda:wkv": 4, "cuda:wkv_backward": 2}


# -------------------------------------------------------------------------
# dryrun_cell
# -------------------------------------------------------------------------
_REF_KEYS = {"arch", "shape", "mesh", "kind", "status", "lower_s",
             "compile_s", "memory", "roofline", "model_flops", "n_chips"}


@pytest.mark.parametrize("arch,shape,lut", [
    ("qwen3-0.6b", "train_4k", False), ("qwen3-0.6b", "prefill_32k", False),
    ("qwen3-0.6b", "decode_32k", True), ("deepseek-moe-16b", "train_4k",
                                         False),
    ("rwkv6-3b", "long_500k", False)])
def test_dryrun_cell_on_a_fake_2x2_group(arch, shape, lut):
    import torch.distributed as dist

    from repro.roofline import RooflineTerms as JTerms

    _, ct = _cfgs(arch, "bfloat16")
    cell = dryrun_cell(arch, shape, False, quiet=True, lut_act=lut, cfg=ct,
                       info=dict(SHAPES[shape], seq=32, batch=4),
                       mesh_shape=(2, 2))
    assert cell["status"] == "ok", cell.get("trace")
    assert not dist.is_initialized()
    assert _REF_KEYS <= set(cell)
    assert set(cell["roofline"]) == set(JTerms(0, 0, 0, {}).as_dict())
    assert {"argument_size_in_bytes", "temp_size_in_bytes"} <= set(
        cell["memory"])
    assert cell["mesh"] == "2x2" and cell["n_chips"] == 4
    assert cell["compile_s"] == 0.0 and cell["fits_80gb"]
    assert cell["peak_bytes"] == (cell["memory"]["argument_size_in_bytes"]
                                  + cell["memory"]["temp_size_in_bytes"])
    rf = cell["roofline"]
    assert rf["flops"] > 0 and rf["hbm_bytes"] > 0
    # the weights are gathered over the model axis at the step's entry
    assert rf["per_op_coll"].get("all-gather", 0) > 0
    if lut:
        assert set(cell["lut_tables"]) == {"sites", "replicated_bytes",
                                           "sharded_bytes",
                                           "per_device_bytes"}
        assert cell["launches"] == {"cuda:lut_act": ct.n_layers}
    if arch == "rwkv6-3b":
        assert cell["launches"] == {}     # decode: the recurrence, no K8
    json.dumps(cell)


class _Allocated:
    """A dispatch mode recording ``(shape, dtype)`` of every tensor an
    operation returns (outside the trace's own modes, so it sees what
    they run)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        seen = self.seen = set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                seen.update((tuple(t.shape), t.dtype)
                            for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
                return out

        self.mode = Mode()


@pytest.mark.parametrize("depth,compress,limit", [
    (10, False, 20e9), (28, False, 48e9), (10, True, None)])
def test_moe_training_rank_holds_expert_shares(depth, compress, limit):
    """One 1x4 rank of deepseek-moe-16b's training step at its published
    widths (4 x 64, no remat, on the meta device): no tensor of a whole
    expert stack's shape is made (gradient, float32 copy, error buffer),
    and without compression no float32 tensor of a share's either (the
    norm takes one slab at a time, AdamW one layer); the rank's peak
    below ``limit`` (the whole-stack step's: 48.2 GB at 10 layers, 133.4
    at 28)."""
    from repro_torch.train import TrainConfig

    cfg = dataclasses.replace(tconfigs.get_config("deepseek-moe-16b"),
                              n_layers=depth)
    m, d = cfg.moe, cfg.d_model
    stacks = [(depth, m.n_experts, d, 2 * m.d_expert),
              (depth, m.n_experts, m.d_expert, d)]
    shares = [(s[0], s[1] // 4, *s[2:]) for s in stacks]
    rec = _Allocated()
    with rec.mode:
        cell = dryrun_cell("deepseek-moe-16b", "train_4k", False, quiet=True,
                           tcfg=TrainConfig(remat=False,
                                            grad_compress=compress),
                           cfg=cfg, info=dict(kind="train", seq=64, batch=4),
                           mesh_shape=(1, 4))
    assert cell["status"] == "ok", cell.get("trace")
    assert shares[0] in {s for s, _ in rec.seen}     # the mode saw the step
    assert not [s for s, _ in rec.seen if s in stacks]
    if not compress:
        assert not [s for s, dt in rec.seen
                    if s in shares and dt == torch.float32]
    if limit is not None:
        assert cell["peak_bytes"] < limit, cell["peak_bytes"]


def test_unsupported_cell_is_skipped_with_the_reference_reason():
    import os

    # the reference's module sets XLA_FLAGS (512 host devices) on import;
    # jax reads it at its first backend use, so it is put back at once
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    cell = dryrun_cell("qwen3-0.6b", "long_500k", False)
    ok, why = jdry.cell_supported(jconfigs.get_config("qwen3-0.6b"),
                                  "long_500k")
    assert cell["status"] == "skipped" and cell["reason"] == why and not ok


def test_dryrun_cli_writes_and_caches(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "SHAPES", {"decode_32k": dict(
        kind="decode", seq=64, batch=32)})
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tconfigs.smoke_config(
                            tconfigs.get_config(a)))
    out = str(tmp_path / "d")
    dryrun.main(["--arch", "qwen3-0.6b", "--both-meshes", "--out", out])
    files = sorted(p.name for p in (tmp_path / "d").iterdir())
    assert files == ["qwen3-0.6b__decode_32k__mp.json",
                     "qwen3-0.6b__decode_32k__sp.json"]
    mp = json.loads((tmp_path / "d" / files[0]).read_text())
    assert mp["status"] == "ok" and mp["mesh"] == "2x16x16"
    dryrun.main(["--arch", "qwen3-0.6b", "--both-meshes", "--out", out])
    assert capsys.readouterr().out.count("[cached]") == 2


# -------------------------------------------------------------------------
# the levers
# -------------------------------------------------------------------------
@pytest.fixture
def fast_stream():
    from repro.nn.layers import set_fast_stream as j_set
    from repro_torch.nn.layers import set_fast_stream as t_set

    def both(on):
        j_set(on)
        t_set(on)

    yield both
    both(False)


def _bf16(a):
    return jnp.asarray(a, dtype=jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _close(t, j, rtol=BF16_RTOL):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=rtol, atol=1e-6)


def test_fast_stream_layers_match_reference(fast_stream):
    from repro.nn.attention import decode_attend as j_attend
    from repro.nn.layers import rms_norm as j_norm
    from repro.nn.rope import apply_rope as j_rope
    from repro_torch.nn.attention import decode_attend as t_attend
    from repro_torch.nn.layers import rms_norm as t_norm
    from repro_torch.nn.rope import apply_rope as t_rope

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    sc = rng.normal(size=(64,)).astype(np.float32) * 0.1
    r = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 12, 2, 32)).astype(np.float32)
    outs = {}
    for on in (False, True):
        fast_stream(on)
        (xj, xt), (sj, st), (rj, rt) = _bf16(x), _bf16(sc), _bf16(r)
        (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(kc), _bf16(vc)
        got = [t_norm(xt, st), t_rope(rt, torch.from_numpy(pos), 1e4),
               t_attend(qt, kt, vt, 7)]
        want = [j_norm(xj, sj), j_rope(rj, jnp.asarray(pos), 1e4),
                j_attend(qj, kj, vj, jnp.int32(7))]
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            _close(g, w)
        outs[on] = got
    # the lever acts: the bf16 stream rounds where the float32 one did not
    assert not torch.equal(outs[False][0], outs[True][0])
    assert not torch.equal(outs[False][1], outs[True][1])


def test_fast_stream_smoke_loss_matches_reference(fast_stream):
    from repro.nn.transformer import init_params as j_init
    from repro.nn.transformer import loss_fn as j_loss_fn
    from repro_torch.bridge import params_from_jax
    from repro_torch.nn.transformer import loss_fn as t_loss_fn

    cj, ct = _cfgs("qwen3-0.6b", "bfloat16")
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cj.vocab_size, (2, 17)).astype(np.int32)
    bj = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    bt = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    losses = {}
    for on in (False, True):
        fast_stream(on)
        lj = float(j_loss_fn(cj)(pj, batch=bj))
        lt = float(t_loss_fn(ct)(pt, batch=bt))
        assert abs(lt - lj) <= FAST_LOSS_RTOL * abs(lj), (on, lt, lj)
        losses[on] = lt
    assert abs(losses[True] - losses[False]) <= FAST_LOSS_RTOL * abs(
        losses[False])


@pytest.mark.parametrize("chunk", [16, 8, 4])
def test_wkv_chunk_lever_matches_reference(chunk):
    from repro.nn import ssm as jssm
    from repro.nn.transformer import init_params as j_init
    from repro.serve.decode import prefill as j_prefill
    from repro_torch.bridge import params_from_jax
    from repro_torch.nn import ssm as tssm
    from repro_torch.serve import prefill as t_prefill

    cj, ct = _cfgs("rwkv6-3b")
    pj = j_init(cj, jax.random.PRNGKey(0))
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    toks = np.random.default_rng(2).integers(1, cj.vocab_size, (2, 21))
    try:
        jssm.set_wkv_chunk(chunk)
        tssm.set_wkv_chunk(chunk)
        assert tssm.WKV_CHUNK == chunk
        lj, sj = j_prefill(pj, cj, {"tokens": jnp.asarray(toks, jnp.int32)})
        lt, st = t_prefill(pt, ct, {"tokens": torch.from_numpy(toks)})
    finally:
        jssm.set_wkv_chunk(64)
        tssm.set_wkv_chunk(64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st["wkv"].numpy(), np.asarray(sj["wkv"]),
                               rtol=0, atol=1e-4)


def test_hillclimb_run_variant_on_smoke_cells(tmp_path):
    from repro_torch.launch import hillclimb
    from repro_torch.nn import layers, ssm

    _, cq = _cfgs("qwen3-0.6b", "bfloat16")
    _, cn = _cfgs("nemotron-4-15b", "bfloat16")
    _, cr = _cfgs("rwkv6-3b", "bfloat16")
    small = lambda s: dict(SHAPES[s], seq=32, batch=8)
    kw = dict(mesh_shape=(2, 2), out_dir=str(tmp_path))
    runs = [
        ("rwkv6-3b", "train_4k", "v2_micro4_fast",
         dict(microbatch=4, fast_stream=True, cfg=cr)),
        ("rwkv6-3b", "train_4k", "v5_chunk8", dict(wkv_chunk=8, cfg=cr)),
        ("qwen3-0.6b", "train_4k", "v3_sp", dict(seq_parallel=True, cfg=cq)),
        ("qwen3-0.6b", "train_4k", "v4_sp_fast",
         dict(seq_parallel=True, fast_stream=True, cfg=cq)),
        ("nemotron-4-15b", "decode_32k", "v3_fast_int8_lut",
         dict(fast_stream=True, kv_dtype="int8", lut_act=True, cfg=cn)),
    ]
    res = {name: hillclimb.run_variant(arch, shape, name, info=small(shape),
                                       **kw, **v)
           for arch, shape, name, v in runs}
    assert layers.FAST_STREAM is False and ssm.WKV_CHUNK == 64
    for name in ("v2_micro4_fast", "v5_chunk8", "v3_fast_int8_lut"):
        assert res[name]["status"] == "ok", res[name].get("trace")
        assert res[name]["roofline"]["flops"] > 0
    for name in ("v3_sp", "v4_sp_fast"):
        assert res[name]["status"] == "skipped"
        assert "sequence parallelism" in res[name]["reason"]
    assert res["v3_fast_int8_lut"]["launches"] == {
        "cuda:lut_act": cn.n_layers}
    assert res["v5_chunk8"]["launches"]["cuda:wkv"] > 0
    assert len(list(tmp_path.iterdir())) == len(runs)
    # a variant that fails is recorded, and its levers are reset
    bad = hillclimb.run_variant("rwkv6-3b", "train_4k", "bad",
                                fast_stream=True, wkv_chunk=8, cfg=cr,
                                info=dict(small("train_4k"), batch=3), **kw)
    assert bad["status"] == "error"
    assert layers.FAST_STREAM is False and ssm.WKV_CHUNK == 64
