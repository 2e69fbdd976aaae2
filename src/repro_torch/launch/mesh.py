"""Meshes of ranks (counterpart of the reference's ``launch/mesh.py``) and
the way to start them.

A mesh position is a process.  :func:`run_ranks` starts ``dp * tp`` of
them from this one (``spawn``), or a launcher such as ``torchrun`` starts
them and each joins with :func:`join_from_env`.  Rank ``r`` serves on
``cuda:(r % device_count)`` (``cuda:r`` where there are as many cards as
ranks), made the current device before the process group is joined, so
``broadcast_object_list`` and ``all_gather_object`` run on it; or on the
CPU.  The collective backend follows the layout (:func:`choose_backend`):
NCCL when every rank has a card of its own, gloo where ranks share a card
(NCCL refuses two ranks on one device) and on the CPU.  The choice is
logged, and nothing switches backend after a failure: a failed collective
raises, and a rank that fails fails the run.

NCCL's ranks live on one host and need no network: :data:`NCCL_ENV`
(set where the environment does not set it already) keeps its bootstrap
on the loopback device and skips the InfiniBand probe; the transfers go
card to card over NVLink / PCIe peer access.  The process group's store
is ``tcp://localhost``.

Importing this module starts nothing and touches no device.
"""
from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.nn.sharding import Mesh, new_axis_groups

HOST_AXES = ("data", "model")

# NCCL on one host without a network: bootstrap over the loopback device,
# no InfiniBand probe (defaults; the environment's own values win)
NCCL_ENV = {"NCCL_SOCKET_IFNAME": "lo", "NCCL_IB_DISABLE": "1"}


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """``"nccl"`` when each of ``world`` ranks has its own card, else
    ``"gloo"`` (ranks sharing a card, or the CPU)."""
    if device_type == "cuda" and world <= n_cards:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)``, or the
    CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available on this machine; pass "
            "device='cpu' (launcher: --device cpu) to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_shape(dp: int, tp: int) -> None:
    if dp < 1 or tp < 1:
        raise ValueError(
            f"make_host_mesh: dp and tp must be >= 1, got dp={dp} tp={tp}")


def make_host_mesh(dp: int = 1, tp: int = 1, device=None) -> Mesh:
    """This process's ``(data, model)`` mesh of ``dp x tp`` ranks on its
    ``device`` (what :func:`join` set), over the process group it has
    joined (:func:`join_from_env`, :func:`run_ranks`) — validated up
    front, as the reference validates its device count."""
    _check_shape(dp, tp)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp != world:
        raise ValueError(
            f"make_host_mesh: mesh {dp}x{tp} needs {dp * tp} ranks but "
            f"{world} are running — start them with "
            f"repro_torch.launch.mesh.run_ranks, torchrun or the serve "
            f"launcher's --mesh (or shrink the mesh)")
    return _bound_mesh(HOST_AXES, (dp, tp), device)


def mesh_or_none(dp: int = 1, tp: int = 1) -> Mesh | None:
    """``None`` for the trivial 1x1 request, else :func:`make_host_mesh`.
    Ranks can share a card, so the port builds every mesh it is asked for
    and never degrades a request to one device (the reference returns
    ``None`` when its visible devices cannot hold the mesh)."""
    if dp * tp <= 1:
        return None
    return make_host_mesh(dp, tp)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production shapes: 16 x 16 ranks a pod; two pods
    add a leading pure-data ``pod`` axis (512 ranks).  Needs a process
    group of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else HOST_AXES
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"make_production_mesh: {n} ranks needed, "
                         f"{world} running")
    return _bound_mesh(axes, shape, device)


def _bound_mesh(axes: tuple, shape: tuple, device) -> Mesh:
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = Mesh(axes, shape, rank=rank,
                device=torch.device(device) if device is not None else None,
                backend=dist.get_backend() if dist.is_initialized() else None)
    mesh.groups = (new_axis_groups(mesh) if dist.is_initialized()
                   else {a: None for a in axes})
    return mesh


def join(rank: int, world: int, addr: str, port: int, device: str,
         log=print) -> torch.device:
    """Set this rank's device and join the process group of ``world``
    ranks at ``tcp://addr:port`` with the backend the layout calls for;
    returns the device."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, world, n_cards)
    kw = {}
    if backend == "nccl":
        for k, v in NCCL_ENV.items():
            os.environ.setdefault(k, v)
        kw["device_id"] = dev
    if rank == 0:
        log(f"mesh: {world} ranks on {dev.type}"
            + (f" ({n_cards} card(s), {world} rank(s))"
               if dev.type == "cuda" else "")
            + f", collective backend {backend}"
            + (", " + " ".join(f"{k}={os.environ[k]}" for k in NCCL_ENV)
               if backend == "nccl" else ""))
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world, **kw)
    return dev


def join_from_env(device: str, log=print) -> torch.device:
    """Join the process group ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)."""
    return join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                os.environ.get("MASTER_ADDR", "localhost"),
                int(os.environ["MASTER_PORT"]), device, log=log)


def in_launched_rank() -> bool:
    """True in a process ``torchrun`` (or the like) started as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank, world, port, dp, tp, device, out_dir):
    """A spawned rank: join, build the mesh, run ``fn(mesh, *args)``, save
    its result (or the traceback) for the parent."""
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        mesh = make_host_mesh(
            dp, tp, join(rank, world, "localhost", port, device))
        result = fn(mesh, *args)
        dist.barrier()
        torch.save(result, path + ".pt")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, args=(), *, dp: int, tp: int, device: str = "cuda",
              timeout: float = 1800.0) -> list:
    """Run ``fn(mesh, *args)`` on ``dp * tp`` spawned ranks (``fn`` and
    ``args`` picklable; ``fn`` importable, so a script keeps it in a
    module or behind its ``__main__`` guard) and return their results in
    rank order.  A rank that fails, or does not finish within
    ``timeout`` seconds, stops the others and raises with its traceback."""
    import torch.multiprocessing as mp

    _check_shape(dp, tp)
    rank_device(0, device)   # no card: raise here, not in every rank
    world = dp * tp
    port = free_port()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, port, dp, tp, device,
                                   out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    failed = bad or "timeout"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if failed is None and any(c != 0 for c in codes):
            failed = [r for r, c in enumerate(codes) if c != 0]
        if failed is not None:
            errs = []
            for r in range(world):
                err = os.path.join(out_dir, f"rank{r}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            what = ("timed out" if failed == "timeout"
                    else f"rank(s) {failed} failed")
            raise RuntimeError(
                f"run_ranks: {what} (exit codes {codes}) on a {dp}x{tp} "
                f"mesh\n" + "\n".join(errs))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
