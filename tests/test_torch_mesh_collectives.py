"""The mesh's collectives and its card-a-rank plumbing on the CPU
(:mod:`repro_torch.nn.sharding`, :mod:`repro_torch.launch.mesh`,
:mod:`repro_torch.serve.sharded`).

On spawned gloo CPU ranks (2x2 and 1x4) a gather through one all-gather
call and through one broadcast a member give the same bytes, every rank's
tensor in coordinate order, for float32 (signed zeros, infinities and a
NaN included), bfloat16, int8 and int32 along dims 0, 1 and -1, and
``gather_rows`` undoes ``batch_placement`` on both routes.  The same
ranks serve a smoke qwen3 through two sessions of ``ShardedServe``: the
gathered weights stay in the same buffers and the logits are the
single-device program's, bit for bit; the captured step is refused there
(gloo, the CPU).  Without ranks: the route table, where four cards put
rank ``r`` (``cuda:r``, NCCL, the device set before the group is
joined), which ranks may capture, and ``chip_smoke.py --cards 4``'s
guard against fewer cards.  NCCL itself and the captured step run on the
card (``chip_smoke.py --cards 4``, phase 25)."""
import dataclasses
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
DTYPES = ("float32", "bfloat16", "int8", "int32")
DIMS = (0, 1, -1)
ROUTES = ("all_gather", "broadcasts")
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
T, NEW = 8, 2


# -------------------------------------------------------------------------
# what the ranks run (importable: the ranks are spawned)
# -------------------------------------------------------------------------
def rank_tensor(rank: int, dtype: str) -> torch.Tensor:
    """A (3, 4, 5) tensor of ``rank``'s own, from a seed: normal floats
    with -0.0, +-inf and a NaN at the front, or integers over the whole
    range of the type."""
    g = np.random.default_rng(100 + rank)
    if dtype in ("float32", "bfloat16"):
        a = g.normal(size=(3, 4, 5)).astype(np.float32)
        a.flat[:4] = [-0.0, np.inf, -np.inf, np.nan]
        return torch.from_numpy(a).to(getattr(torch, dtype))
    info = np.iinfo(dtype)
    return torch.from_numpy(g.integers(info.min, info.max, size=(3, 4, 5),
                                       endpoint=True).astype(dtype))


def global_rows() -> dict:
    return {"tokens": torch.arange(4 * 6).reshape(4, 6),
            "x": torch.from_numpy(np.random.default_rng(7).normal(
                size=(4, 3)).astype(np.float32))}


def _gathers(mesh) -> dict:
    """Every (dtype, dim) gathered over both axes, and the placed rows
    gathered back, on the route in force."""
    from repro_torch.nn import sharding as sh
    from repro_torch.serve.sharded import batch_placement, gather_rows

    out = {}
    for dtype in DTYPES:
        t = rank_tensor(mesh.rank, dtype)
        for dim in DIMS:
            out[dtype, dim] = {a: sh.gather(t, mesh, a, dim)
                               for a in ("data", "model")}
    out["rows"] = {k: gather_rows(v, mesh) for k, v in
                   batch_placement(mesh, global_rows()).items()}
    return out


def _smoke():
    from repro_torch.calib import model_batch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.nn import init_params

    cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              dtype="float32")
    batch = model_batch(cfg, np.random.default_rng(0), 4, T)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    return cfg, init_params(cfg, 0, "cpu"), batch


def _greedy(prefill_fn, step_fn):
    """Prefill, then NEW greedy steps: the last-position logits of each."""
    logits, cache = prefill_fn()
    seen = [logits[:, -1].clone()]
    for i in range(NEW):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, cache = step_fn(cache, tok, T + i)
        seen.append(logits[:, -1].clone())
    return seen


def _held_sessions(mesh) -> dict:
    """Two sessions of one ShardedServe on this rank's shares: the held
    weights' addresses in each, and each session's logits; the
    single-device logits on this rank's rows; what the captured route
    says here."""
    from repro_torch.serve import decode_step, prefill
    from repro_torch.serve.sharded import (
        ShardedCapturedStep,
        ShardedServe,
    )

    cfg, params, batch = _smoke()
    serve = ShardedServe(cfg, mesh)
    shares = serve.place_params(params)
    local = serve.place_batch(batch)
    ptrs, fulls, logits = [], [], []
    for _ in range(2):
        with serve.session(shares) as full:
            fulls.append(full)
            ptrs.append({n: p.data_ptr() for n, p in full.named_parameters()})
            logits.append(_greedy(
                lambda: serve.prefill(shares, local, T + NEW),
                lambda c, tk, pos: serve.decode(shares, c, tk, pos)))
    rows = local["tokens"].shape[0]
    lo = mesh.index("data") * rows
    one = {k: v[lo:lo + rows] for k, v in batch.items()}
    single = _greedy(
        lambda: prefill(params, cfg, one, max_seq=T + NEW),
        lambda c, tk, pos: decode_step(params, cfg, c, tk, pos))
    try:
        ShardedCapturedStep(serve)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    step = serve.decode_fn(shares)
    return {"ptrs": ptrs, "same_object": fulls[0] is fulls[1],
            "n_gathered": sum(p.shape != s.shape for p, s in zip(
                fulls[0].parameters(), shares.parameters())),
            "logits": logits, "single": single, "refusal": refusal,
            "eager_step": not isinstance(step, ShardedCapturedStep)}


def mesh_rank(mesh) -> dict:
    from repro_torch.nn import sharding as sh

    torch.set_num_threads(1)
    natural = sh.gather_route(dist.get_backend(mesh.group("data")), "cpu")
    out = {"natural": natural, "backend": mesh.backend}
    orig = sh.gather_route
    try:
        for route in ROUTES:
            sh.gather_route = lambda backend, device_type, r=route: r
            out[route] = _gathers(mesh)
    finally:
        sh.gather_route = orig
    out["held"] = _held_sessions(mesh)
    return out


# -------------------------------------------------------------------------
# the tests
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks():
    from repro_torch.launch.mesh import run_ranks

    return {name: run_ranks(mesh_rank, dp=dp, tp=tp, device="cpu",
                            timeout=600)
            for name, (dp, tp) in SHAPES.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _layout(shape: str):
    from repro_torch.nn.sharding import Mesh

    return Mesh(("data", "model"), SHAPES[shape])


@pytest.mark.parametrize("shape,case", [
    (s, (dt, dim)) for s in SHAPES for dt in DTYPES for dim in DIMS]
    + [(s, "rows") for s in SHAPES],
    ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
def test_gather_routes_agree_byte_for_byte(ranks, shape, case):
    """The all-gather route (what gloo on the CPU and NCCL on the card
    take) and the broadcast route (gloo on the card) give every rank the
    same bytes, which are every member's tensor concatenated in
    coordinate order; ``gather_rows`` undoes ``batch_placement``."""
    layout = _layout(shape)
    for rank, out in enumerate(ranks[shape]):
        assert out["natural"] == "all_gather" and out["backend"] == "gloo"
        if case == "rows":
            for k, v in global_rows().items():
                for route in ROUTES:
                    assert torch.equal(_bits(out[route]["rows"][k]),
                                       _bits(v)), (rank, route, k)
            continue
        dtype, dim = case
        for axis in ("data", "model"):
            want = torch.cat([rank_tensor(r, dtype) for r in
                              layout.members(axis, rank)], dim)
            for route in ROUTES:
                got = out[route][case][axis]
                assert got.shape == want.shape and got.dtype == want.dtype
                assert torch.equal(_bits(got), _bits(want)), (
                    rank, axis, route)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_held_weights_keep_their_buffers_across_sessions(ranks, shape):
    """Two sessions gather into the same buffers (the same params object,
    every address unchanged), and both serve the single-device logits on
    the rank's rows, bit for bit."""
    for rank, out in enumerate(ranks[shape]):
        h = out["held"]
        assert h["same_object"] and h["ptrs"][0] == h["ptrs"][1], rank
        assert h["n_gathered"] > 0
        for session in h["logits"]:
            for a, b in zip(session, h["single"]):
                assert torch.equal(_bits(a), _bits(b)), rank


@pytest.mark.parametrize("shape", list(SHAPES))
def test_captured_route_refused_on_gloo_cpu_ranks(ranks, shape):
    """A gloo rank on the CPU gets the eager step from ``decode_fn`` and a
    refusal naming gloo and the CPU from the captured step."""
    for out in ranks[shape]:
        h = out["held"]
        assert h["eager_step"]
        assert "gloo" in h["refusal"] and "cpu" in h["refusal"]


@pytest.mark.parametrize("backend,device_type,route", [
    ("nccl", "cuda", "all_gather"),
    ("gloo", "cpu", "all_gather"),
    ("gloo", "cuda", "broadcasts"),
])
def test_gather_route_table(backend, device_type, route):
    from repro_torch.nn.sharding import gather_route

    assert gather_route(backend, device_type) == route


@pytest.mark.parametrize("backend,device,names", [
    ("nccl", "cuda:0", ()),
    ("gloo", "cuda:0", ("gloo",)),
    ("nccl", "cpu", ("cpu",)),
    ("gloo", "cpu", ("gloo", "cpu")),
])
def test_capture_refusal_names_what_blocks_it(backend, device, names):
    from repro_torch.nn.sharding import Mesh
    from repro_torch.serve.sharded import capture_refusal

    why = capture_refusal(Mesh(("data", "model"), (2, 2), rank=0,
                               device=torch.device(device), backend=backend))
    if not names:
        assert why is None
    else:
        assert all(n in why for n in names), why


def _four_cards(monkeypatch, calls=None):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if calls is not None:
        monkeypatch.setattr(torch.cuda, "set_device",
                            lambda d: calls.append(("set_device", d)))
        monkeypatch.setattr(
            dist, "init_process_group",
            lambda backend, **kw: calls.append(("init", backend, kw)))


def test_four_cards_put_rank_r_on_cuda_r_under_nccl(monkeypatch):
    from repro_torch.launch.mesh import choose_backend, rank_device

    _four_cards(monkeypatch)
    assert [rank_device(r, "cuda") for r in range(4)] == [
        torch.device("cuda", r) for r in range(4)]
    assert choose_backend("cuda", 4, torch.cuda.device_count()) == "nccl"
    assert choose_backend("cuda", 4, 2) == "gloo"      # ranks share cards
    assert choose_backend("cpu", 4, 4) == "gloo"


@pytest.mark.parametrize("rank", [0, 3])
def test_join_sets_the_card_before_the_nccl_group(monkeypatch, rank):
    """``join`` makes ``cuda:rank`` current, then joins NCCL with it as
    the group's device, the loopback bootstrap set where the environment
    sets none; rank 0 logs the choice."""
    from repro_torch.launch import mesh as mesh_mod

    for k in mesh_mod.NCCL_ENV:
        monkeypatch.delenv(k, raising=False)
    calls, logged = [], []
    _four_cards(monkeypatch, calls)
    dev = mesh_mod.join(rank, 4, "localhost", 12345, "cuda",
                        log=logged.append)
    assert dev == torch.device("cuda", rank)
    assert calls[0] == ("set_device", dev)
    assert calls[1][:2] == ("init", "nccl")
    assert calls[1][2]["device_id"] == dev
    assert calls[1][2]["init_method"] == "tcp://localhost:12345"
    assert all(os.environ[k] == v for k, v in mesh_mod.NCCL_ENV.items())
    assert len(logged) == (rank == 0)
    if logged:
        assert "nccl" in logged[0] and "NCCL_SOCKET_IFNAME=lo" in logged[0]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cards", [1, 3])
def test_chip_smoke_cards_guard_refuses_fewer_cards(monkeypatch, capsys,
                                                    tmp_path, cards):
    """``chip_smoke.py --cards 4`` with fewer cards visible exits non-zero
    and names the count, before it builds or runs anything."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(cs, "OUT_DIR", tmp_path / "out")
    assert cs.main(["--cards", "4"]) != 0
    assert not (tmp_path / "out").exists()
    err = capsys.readouterr()
    assert f"{cards} card" in err.err and "4" in err.err
    assert not err.out.strip()
