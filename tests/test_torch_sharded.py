"""Sharded serving on spawned CPU ranks joined over gloo
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.serve.sharded`): the
sharded program against the single-device one, bit for bit where each
data rank holds at least 2 rows, and the 2x2 tokens against the
reference's ``ShardedServe`` on forced host devices.

Each mesh shape starts its ranks once (a module fixture) and runs every
scenario of that shape in them; a test reads its scenario's outcome.  The
``cuda`` backend needs the card, so these name the ``gather`` backend
alone (``chip_smoke.py`` phase 22 serves the ``cuda`` backend on the
card)."""
import dataclasses
import functools
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N_NEW = 3


# -------------------------------------------------------------------------
# what the ranks run (importable: the ranks are spawned)
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _setup(arch: str, *, per_site: bool = False, batch: int = 4,
           seq: int = 8):
    """(cfg, params, plans, batch): the mesh suite's inputs on the port —
    the float32 smoke config, seed-0 weights, a seed-0 shared calibration
    (or a capture of two batches per site) and a 4 x 8 batch.  Built once
    a rank (nothing below mutates them)."""
    from repro_torch.calib import capture_calibration, model_batch
    from repro_torch.calib import synthetic_batches
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.nn import init_params
    from repro_torch.serve import build_serving_plans

    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    params = init_params(cfg, 0, "cpu")
    if per_site:
        calib = capture_calibration(params, cfg, synthetic_batches(
            cfg, 2, batch_size=2, seq_len=seq, seed=1))
    else:
        calib = rng.normal(size=20000) * 3
    plans = build_serving_plans(cfg, calib)
    cfg = plans.patched_config(cfg)
    return cfg, params, plans, model_batch(cfg, rng, batch, seq)


def _verify(mesh, arch, **kw):
    from repro_torch.serve import verify_backend_equivalence

    per_site = kw.pop("per_site", False)
    cfg, params, plans, batch = _setup(arch, per_site=per_site)
    return verify_backend_equivalence(cfg, params, plans, batch, N_NEW,
                                      mesh=mesh, backends=("gather",), **kw)


def sc_family(mesh, arch):
    return {"tokens": _verify(mesh, arch)}


def sc_plan_exec(mesh, arch="qwen3-0.6b"):
    """Per-site plans in both execution forms: stacked (L, ...) slabs and
    one entry per layer."""
    out = {e: _verify(mesh, arch, per_site=True, plan_exec=e)
           for e in ("stacked", "unrolled")}
    assert out["stacked"] == out["unrolled"]
    return {"tokens": out["stacked"]}


def sc_layer_sharded(mesh, arch="qwen3-0.6b"):
    """Threshold 0 splits the per-site slab by layer over the data axis;
    the report counts what a rank holds (its share and the resident
    buffer: more than the replicated slab); the buffers are filled with
    junk after placement, so only the step's gather can make the tokens
    right."""
    from repro_torch.serve import PlacementPolicy, plan_placement_report
    from repro_torch.serve import verify_backend_equivalence
    from repro_torch.serve.sharded import _arrays_nbytes

    cfg, params, plans, batch = _setup(arch, per_site=True)
    policy = PlacementPolicy(shard_threshold_bytes=0)
    placed = plans.tables_for_model(backend="gather", device="cpu",
                                    mesh=mesh, policy=policy)
    report = plan_placement_report(
        plans.tables_for_model(backend="gather", device="cpu"), mesh, policy)
    placements = {s: r["placement"] for s, r in report["sites"].items()}
    assert "layer_sharded" in placements.values(), placements
    held = 0
    for entry in placed["sites"].values():
        held += _arrays_nbytes(entry)
        st = entry.get("stacked")
        if st is not None and "layer_shard" in st:
            held += _arrays_nbytes(st["layer_shard"].shard)
            for t in [*st["arrays"].values(), st["meta_i"], st["meta_f"]]:
                t.fill_(7)
    assert held == report["per_device_bytes"] > (report["replicated_bytes"]
                                                 + report["sharded_bytes"])
    toks = verify_backend_equivalence(cfg, params, plans, batch, N_NEW,
                                      mesh=mesh, backends=("gather",),
                                      table_overrides={"gather": placed})
    return {"tokens": toks, "placements": placements}


def sc_shard_map(mesh, arch="qwen3-0.6b"):
    """The replicated-tables mode: every slab replicated (a slab placed
    layer-sharded before is gathered once), the same tokens as the
    single-device program, and replay refused in the reference's words."""
    from repro_torch.serve import PlacementPolicy, ShardedServe
    from repro_torch.serve.plans import _greedy
    from repro_torch.serve.sharded import batch_placement

    cfg, params, plans, batch = _setup(arch, per_site=True)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    tables = plans.tables_for_model(backend="gather", device="cpu")
    ref_toks, ref_logits = _greedy(cfg, params, batch, N_NEW, None, tables)
    placed = plans.tables_for_model(
        backend="gather", device="cpu", mesh=mesh,
        policy=PlacementPolicy(shard_threshold_bytes=0))
    out = {}
    for name, tabs in (("fresh", tables), ("pre-placed", placed)):
        serve = ShardedServe(cfg, mesh, tabs, mode="shard_map")
        assert all(r["placement"] == "replicated"
                   for r in serve.placement.values()), serve.placement
        toks, logits = _greedy(cfg, serve.place_params(params),
                               serve.place_batch(batch), N_NEW,
                               serve=serve)
        rows = batch_placement(mesh, {"i": torch.arange(4)})["i"].tolist()
        assert toks == [ref_toks[r] for r in rows], name
        out[name] = max(float((r[rows] - s).abs().max())
                        for r, s in zip(ref_logits, logits))
        assert out[name] <= 1e-4, (name, out[name])
    try:
        serve.replay(serve.place_params(params), None, batch["tokens"])
    except NotImplementedError as e:
        out["replay"] = str(e)
    return out


def sc_replay(mesh, arch="qwen3-0.6b"):
    """gspmd replay of the prompt into an int8 cache: each rank's logits
    and cache rows equal the single-device replay's bit for bit."""
    from repro_torch.serve import ShardedServe, init_cache, prefill_replay
    from repro_torch.serve.decode import decode_step

    cfg, params, plans, batch = _setup(arch, per_site=True)
    tokens = torch.as_tensor(batch["tokens"]).long()
    tables = plans.tables_for_model(backend="gather", device="cpu")
    cache = init_cache(cfg, 4, 12, device="cpu", kv_dtype="int8")
    lg, cache = prefill_replay(
        params, cfg, cache, tokens, 0, tables,
        step=lambda c, tk, p: decode_step(params, cfg, c, tk, p, tables))
    serve = ShardedServe(cfg, mesh, plans.tables_for_model(
        backend="gather", device="cpu", mesh=mesh))
    s_cache = serve.place_cache(init_cache(cfg, 4, 12, device="cpu",
                                           kv_dtype="int8"))
    s_lg, s_cache = serve.replay(serve.place_params(params), s_cache,
                                 serve.place_batch({"t": tokens})["t"])
    ref_rows = serve.place_batch({"lg": lg})["lg"]
    assert torch.equal(ref_rows, s_lg)
    for name, t in serve.place_cache(cache).items():
        assert torch.equal(t, s_cache[name]), name
    return {"ok": True}


def sc_batcher(mesh, arch="qwen3-0.6b", prefill="replay"):
    """``ContinuousBatcher(mesh=...)`` serves the single-device batcher's
    outputs through admission, replay or step prefill and eviction."""
    from repro_torch.serve import ContinuousBatcher, Request

    cfg, params, plans, _ = _setup(arch)
    tables = plans.tables_for_model(backend="gather", device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 3, 7, 2, 4, 6)]

    def run(mesh_):
        b = ContinuousBatcher(cfg, params, batch_size=4, max_seq=24,
                              lut_tables=tables, prefill=prefill,
                              mesh=mesh_)
        for rid, p in enumerate(prompts):
            b.submit(Request(rid=rid, prompt=list(p), max_new=4))
        b.run(max_ticks=200)
        assert len(b.finished) == len(prompts), "batcher did not drain"
        return {r.rid: r.out for r in b.finished}

    ref, sharded = run(None), run(mesh)
    assert sharded == ref, f"batcher outputs diverge: {sharded} != {ref}"
    return {"outputs": ref}


def sc_misreplicated(mesh, arch="qwen3-0.6b"):
    """Negative control: a "replicated" slab holding junk on every rank
    but 0 must fail the sharded-against-single-device check, on every
    rank (holding the sharded backends against each other would not)."""
    from repro_torch.serve import verify_backend_equivalence
    from repro_torch.serve.sharded import place_tables

    cfg, params, plans, batch = _setup(arch)
    tables = plans.tables_for_model(backend="gather", device="cpu",
                                    mesh=mesh)
    site = next(iter(tables["sites"]))
    entry = tables["sites"][site]
    key = "stacked" if "stacked" in entry else None
    arrs = entry[key]["arrays"] if key else entry["arrays"]
    bad_arrs = {f: (v.clone() if mesh.rank == 0 else torch.zeros_like(v))
                for f, v in arrs.items()}
    bad_entry = ({key: dict(entry[key], arrays=bad_arrs)} if key
                 else dict(entry, arrays=bad_arrs))
    bad = dict(tables, sites=dict(tables["sites"], **{site: bad_entry}))
    # the corruption survives the serving object's own placement
    placed, _, _ = place_tables(bad, mesh)
    probe = placed["sites"][site]
    probe = probe[key]["arrays"] if key else probe["arrays"]
    assert all(p is bad_arrs[f] for f, p in probe.items())
    try:
        verify_backend_equivalence(cfg, params, plans, batch, N_NEW,
                                   mesh=mesh, backends=("gather",),
                                   table_overrides={"gather": bad})
    except AssertionError as e:
        return {"caught": str(e)[:200]}
    raise AssertionError(
        "verify_backend_equivalence accepted a mis-replicated table slab")


def sc_drift(mesh, arch="qwen3-0.6b"):
    """The drift monitor under the mesh: each data rank counts its rows,
    and the summed counts equal the single-device run's on the batch."""
    from repro_torch import obs, sites
    from repro_torch.calib import capture_calibration, synthetic_batches
    from repro_torch.serve import ShardedServe
    from repro_torch.serve.plans import _greedy

    cfg, params, plans, batch = _setup(arch, per_site=True)
    calib = capture_calibration(params, dataclasses.replace(
        cfg, lut_activation=False), synthetic_batches(
        cfg, 2, batch_size=2, seq_len=8, seed=1))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    tables = plans.tables_for_model(backend="gather", device="cpu")
    with obs.DontCareMonitor(calib, device="cpu") as mon:
        _greedy(cfg, params, batch, N_NEW, None, tables)
    ref = mon.counts()
    serve = ShardedServe(cfg, mesh, plans.tables_for_model(
        backend="gather", device="cpu", mesh=mesh))
    split = (sites.EXPERT,) if cfg.moe else ()
    with obs.DontCareMonitor(calib, device="cpu") as smon:
        smon.bind_mesh(mesh, split)
        _greedy(cfg, serve.place_params(params), serve.place_batch(batch),
                N_NEW, serve=serve)
    got = smon.counts()
    assert {k: v[:2] for k, v in got.items()} == \
        {k: v[:2] for k, v in ref.items()}, (got, ref)
    return {"keys": sorted(got)}


def sc_reference(mesh, arch, ref_dir):
    """The port's 2x2 ranks on the reference's weights, plans and batch:
    tokens equal the reference's ``ShardedServe``'s, and logits within
    1e-4 of its logits in every row but where the port's single-device
    logits (to which the sharded ones are bit for bit equal) already sit
    a table level from the reference's single-device ones: an MLP input
    within float32 rounding of a quantizer edge (ROADMAP queue C).  Those
    rows come back as ``edges``."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.serve import ShardedServe
    from repro_torch.serve.plans import _greedy
    from repro_torch.serve.sharded import batch_placement

    ref = np.load(os.path.join(ref_dir, f"{arch}.npz"))
    cfg, _, plans, batch = _setup(arch)
    assert np.array_equal(batch["tokens"], ref["tokens"])
    tree = {}
    for k in ref.files:
        if k.startswith("p/"):
            *path, leaf = k[2:].split(".")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[k]
    params = params_from_jax(tree, cfg, device="cpu")
    serve = ShardedServe(cfg, mesh, plans.tables_for_model(
        backend="gather", device="cpu", mesh=mesh))
    tokens = torch.as_tensor(batch["tokens"]).long()
    toks, logits = _greedy(cfg, serve.place_params(params),
                           serve.place_batch({"tokens": tokens}), N_NEW,
                           serve=serve)
    rows = batch_placement(mesh, {"i": torch.arange(4)})["i"].tolist()
    want = ref["steps"].T[rows].tolist()
    assert toks == want, (toks, want)
    _, one = _greedy(cfg, params, tokens, N_NEW,
                     lut_tables=plans.tables_for_model(backend="gather",
                                                       device="cpu"))
    diff, edges = 0.0, []
    for i, lg in enumerate(logits):
        d = np.abs(ref["logits"][i][rows] - lg.numpy()).max(axis=1)
        for j, r in enumerate(rows):
            assert torch.equal(lg[j], one[i][r])
            if d[j] > 1e-4:
                single = np.abs(ref["logits_single"][i][r]
                                - one[i][r].numpy()).max()
                assert single > 1e-4, (i, r, d[j], single)
                edges.append((i, r, float(d[j])))
            else:
                diff = max(diff, float(d[j]))
    return {"tokens": toks, "max_logit_diff": diff, "edges": edges}


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
# one spawn a mesh shape
# -------------------------------------------------------------------------
def _reference_dir(tmp) -> str:
    """The reference's 2x2 run (forced host devices, as the mesh suite
    sets them) written to ``tmp``."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable,
                        str(ROOT / "tests" / "torch_mesh_reference.py"),
                        str(tmp)], env=env, capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(tmp)


def _spawn(dp, tp, scenarios):
    from repro_torch.launch.mesh import run_ranks

    return run_ranks(run_scenarios, (scenarios,), dp=dp, tp=tp,
                     device="cpu", timeout=600)


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    ref_dir = _reference_dir(tmp_path_factory.mktemp("ref"))
    return _spawn(2, 2, [
        ("family-qwen3", sc_family, {"arch": "qwen3-0.6b"}),
        ("family-moe", sc_family, {"arch": "deepseek-moe-16b"}),
        ("plan_exec", sc_plan_exec, {}),
        ("plan_exec-moe", sc_plan_exec, {"arch": "deepseek-moe-16b"}),
        ("layer_sharded", sc_layer_sharded, {}),
        ("shard_map", sc_shard_map, {}),
        ("shard_map-moe", sc_shard_map, {"arch": "deepseek-moe-16b"}),
        ("replay", sc_replay, {}),
        ("batcher-replay", sc_batcher, {}),
        ("batcher-step", sc_batcher, {"prefill": "step"}),
        ("batcher-moe", sc_batcher, {"arch": "deepseek-moe-16b"}),
        ("misreplicated", sc_misreplicated, {}),
        ("drift", sc_drift, {}),
        ("reference-qwen3", sc_reference,
         {"arch": "qwen3-0.6b", "ref_dir": ref_dir}),
        ("reference-moe", sc_reference,
         {"arch": "deepseek-moe-16b", "ref_dir": ref_dir}),
    ])


@pytest.fixture(scope="module")
def mesh12():
    return _spawn(1, 2, [
        ("family-qwen3", sc_family, {"arch": "qwen3-0.6b"}),
        ("family-moe", sc_family, {"arch": "deepseek-moe-16b"}),
        ("plan_exec", sc_plan_exec, {}),
        ("shard_map-moe", sc_shard_map, {"arch": "deepseek-moe-16b"}),
        ("drift-moe", sc_drift, {"arch": "deepseek-moe-16b"}),
    ])


@pytest.fixture(scope="module")
def mesh21():
    return _spawn(2, 1, [
        ("family-qwen3", sc_family, {"arch": "qwen3-0.6b"}),
        ("plan_exec", sc_plan_exec, {}),
        ("layer_sharded", sc_layer_sharded, {}),
    ])


def _outcome(ranks, name):
    """The scenario's result on rank 0, after every rank ran it."""
    for r, res in enumerate(ranks):
        status, val = res[name]
        assert status == "ok", f"rank {r}, {name}:\n{val}"
    return ranks[0][name][1]


def _single_tokens(arch):
    from repro_torch.serve import greedy_decode

    cfg, params, plans, batch = _setup(arch)
    return greedy_decode(cfg, params, torch.as_tensor(batch["tokens"]).long(),
                         N_NEW, lut_tables=plans.tables_for_model(
                             backend="gather", device="cpu"))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_family_2x2(mesh22, arch):
    out = _outcome(mesh22, "family-" + ("moe" if "moe" in arch else "qwen3"))
    assert out["tokens"] == _single_tokens(arch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_family_1x2(mesh12, arch):
    """The model axis alone: expert parallelism with no data split."""
    out = _outcome(mesh12, "family-" + ("moe" if "moe" in arch else "qwen3"))
    assert out["tokens"] == _single_tokens(arch)


def test_family_2x1(mesh21):
    assert _outcome(mesh21, "family-qwen3")["tokens"] == _single_tokens(
        "qwen3-0.6b")


@pytest.mark.parametrize("fixture,name", [
    ("mesh22", "plan_exec"), ("mesh22", "plan_exec-moe"),
    ("mesh12", "plan_exec"), ("mesh21", "plan_exec")])
def test_plan_exec_forms(request, fixture, name):
    assert _outcome(request.getfixturevalue(fixture), name)["tokens"]


@pytest.mark.parametrize("fixture", ["mesh22", "mesh21"])
def test_layer_sharded_slab_is_gathered_at_use(request, fixture):
    out = _outcome(request.getfixturevalue(fixture), "layer_sharded")
    assert "layer_sharded" in out["placements"].values()


@pytest.mark.parametrize("fixture,name", [
    ("mesh22", "shard_map"), ("mesh22", "shard_map-moe"),
    ("mesh12", "shard_map-moe")])
def test_shard_map_mode(request, fixture, name):
    out = _outcome(request.getfixturevalue(fixture), name)
    assert out["replay"] == "prefill replay is served in gspmd mode only"


def test_replay_into_int8_cache(mesh22):
    assert _outcome(mesh22, "replay") == {"ok": True}


@pytest.mark.parametrize("name", ["batcher-replay", "batcher-step",
                                  "batcher-moe"])
def test_batcher_on_the_mesh(mesh22, name):
    assert len(_outcome(mesh22, name)["outputs"]) == 6


def test_misreplicated_slab_is_caught(mesh22):
    out = _outcome(mesh22, "misreplicated")
    assert "single-device" in out["caught"]


@pytest.mark.parametrize("fixture,name,keys", [
    ("mesh22", "drift", ["L0/mlp", "L1/mlp"]),
    # the expert site's inputs split over the model axis: summed there too
    # (one data shard: the capacity is the whole batch's)
    ("mesh12", "drift-moe", ["L0/expert", "L0/mlp", "L1/expert", "L1/mlp"])])
def test_drift_counts_summed_over_ranks(request, fixture, name, keys):
    assert _outcome(request.getfixturevalue(fixture), name)["keys"] == keys


@pytest.mark.parametrize("arch,edges", [
    ("qwen3", [(3, 1)]), ("moe", [])])
def test_tokens_equal_reference_sharded_serve(mesh22, arch, edges):
    """Tokens equal on every rank; logits within 1e-4 but at the known
    quantizer edge of qwen3's row 1 at step 3 (6.9e-3), where the
    difference is the single-device one's (``sc_reference``)."""
    outs = [_outcome([r], "reference-" + arch) for r in mesh22]
    assert max(o["max_logit_diff"] for o in outs) <= 1e-4
    assert sorted({e[:2] for o in outs for e in o["edges"]}) == edges
