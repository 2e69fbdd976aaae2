"""Step-atomic checkpoints in the reference's layout (``train/
checkpoint.py``), readable by either package.

Layout::

    <dir>/step_<N>/
        manifest.json    step, a description of the tree, and per leaf its
                         shape, dtype name and crc32 digest
        leaf_<i>.npy     one file per leaf
    <dir>/LATEST         the committed step (written last, so atomic)

Leaves are numbered in the reference's ``jax.tree.flatten`` order of its
train state, which sorts dict keys at every level: ``ef_error.*`` (under
``grad_compress``), ``opt.count``, ``opt.mu.*``, ``opt.nu.*``,
``params.*``, ``step``, each parameter tree by its sorted key path.
bfloat16 leaves are stored as their 16 bits in ``uint16`` (dtype name
``bfloat16``), the counters as int32 0-d arrays; so each leaf file holds
the array, and the digest, that the reference writes for the same state.
Restore checks the leaf count, every digest and shape (and the dtype name
against the state's), all before it writes into the state; it never reads
the tree description.

A rank's state on a mesh (``shardings=``, :func:`repro_torch.train.state.
train_state_shardings`) is saved as full leaves, gathered one leaf at a
time and written by rank 0, so the files are those of a single-device
checkpoint; every rank returns once rank 0 has committed ``LATEST``.
Restore with ``shardings=`` loads the full leaves and keeps each rank's
share: the reference's elastic re-mesh, a checkpoint of any mesh (or of
one device, of either package) restored onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch


def _sorted_names(params: torch.nn.Module) -> list[tuple[str, int]]:
    """``(dotted name, index in the module's order)``, sorted by key path
    as ``jax.tree.flatten`` sorts a nested dict."""
    names = [n for n, _ in params.named_parameters()]
    return sorted(((n, i) for i, n in enumerate(names)),
                  key=lambda ni: ni[0].split("."))


def state_leaves(state: dict) -> list[tuple[str, object]]:
    """``(path, leaf)`` in the reference's leaf order; a leaf is a tensor
    or, for ``opt.count`` and ``step``, a host int."""
    if "params" not in state:
        raise ValueError(f"train state: no 'params' among {sorted(state)}")
    order = _sorted_names(state["params"])
    plist = list(state["params"].parameters())
    tree = lambda prefix, ts: [(f"{prefix}.{n}", ts[i]) for n, i in order]
    leaves = []
    for key in sorted(state):
        if key == "params":
            leaves += tree("params", plist)
        elif key == "opt":
            leaves.append(("opt.count", state["opt"]["count"]))
            leaves += tree("opt.mu", state["opt"]["mu"])
            leaves += tree("opt.nu", state["opt"]["nu"])
        elif key == "ef_error":
            leaves += tree("ef_error", state["ef_error"])
        elif key == "step":
            leaves.append(("step", state["step"]))
        else:
            raise ValueError(f"train state: unknown key {key!r}")
    return leaves


def leaf_placements(state: dict, shardings: dict | None) -> list:
    """The placement of each of :func:`state_leaves`' leaves under
    ``shardings`` (all ``None`` without)."""
    leaves = state_leaves(state)
    if shardings is None:
        return [None] * len(leaves)
    by_path = {"opt.count": shardings["opt"]["count"],
               "step": shardings["step"]}
    for prefix, tree in (("params", shardings["params"]),
                         ("opt.mu", shardings["opt"]["mu"]),
                         ("opt.nu", shardings["opt"]["nu"]),
                         ("ef_error", shardings.get("ef_error", {}))):
        by_path.update({f"{prefix}.{n}": pl for n, pl in tree.items()})
    return [by_path[p] for p, _ in leaves]


def full_leaves(state: dict, shardings: dict | None = None):
    """``(path, full leaf)`` in :func:`state_leaves`' order, a rank's
    shares gathered one leaf at a time under ``shardings`` (a collective:
    every rank of the mesh runs the loop to its end)."""
    for (path, leaf), pl in zip(state_leaves(state),
                                leaf_placements(state, shardings)):
        if pl is not None and isinstance(leaf, torch.Tensor):
            leaf = pl.gather(leaf.detach())
        yield path, leaf


def _mesh_of(shardings: dict | None):
    return None if shardings is None else shardings["step"].mesh


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf, np.int32), "int32"
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(
            np.array(arr).view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says "
                         f"{dtype_name}")
    return torch.from_numpy(np.array(arr))


def save_checkpoint(ckpt_dir: str, state: dict, step: int,
                    shardings: dict | None = None) -> str:
    """Write ``state`` as ``step_<step>`` and commit it in ``LATEST``.
    With ``shardings`` (a rank's state on a mesh) every rank calls it:
    the leaves are gathered one at a time, rank 0 writes them, and all
    return after the commit."""
    mesh = _mesh_of(shardings)
    writer = mesh is None or mesh.rank == 0
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    leaves = []
    for i, (path, leaf) in enumerate(full_leaves(state, shardings)):
        if writer:
            stored, dtype_name = _to_storable(leaf)
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), stored)
            leaves.append({"shape": list(stored.shape), "dtype": dtype_name,
                           "crc32": zlib.crc32(stored.tobytes()),
                           "path": path})
    if writer:
        manifest = {"step": step,
                    "treedef": "repro_torch train state: "
                               + ", ".join(m["path"] for m in leaves),
                    "leaves": leaves}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
                   os.path.join(ckpt_dir, "LATEST"))
    if mesh is not None:
        from repro_torch.nn.sharding import all_reduce

        # the ranks wait for rank 0's commit (read back: an NCCL
        # all-reduce returns to the host before it completes)
        float(all_reduce(torch.zeros(1, device=mesh.device or "cpu"), mesh))
    return final


def latest_step(ckpt_dir: str) -> int | None:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, state: dict, step: int | None = None,
                       verify: bool = True, shardings: dict | None = None):
    """Restore ``step`` (default: ``LATEST``) into ``state``, in place
    (tensors copied into, counters set).  Returns ``(state, step)``.
    Raises ``FileNotFoundError`` without a checkpoint, ``ValueError`` on
    a leaf count, shape or dtype that differs from the state's, ``IOError``
    on a digest mismatch; the state is untouched when it raises.  With
    ``shardings`` ``state`` is a rank's shares on a mesh: each full leaf
    must have the shape those shares make up, and the rank keeps its
    share (elastic re-mesh)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = state_leaves(state)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"state expects {len(leaves)}")
    loaded = []
    for i, (meta, (path, like), pl) in enumerate(zip(
            manifest["leaves"], leaves, leaf_placements(state, shardings))):
        arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
        if verify and zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"digest mismatch on leaf {i} of step {step}")
        t = _from_storable(arr, meta["dtype"])
        shape = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
        if pl is not None:
            shape = tuple(n * pl.parts(j) for j, n in enumerate(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"leaf {i} ({path}): checkpoint shape "
                             f"{tuple(t.shape)} != {shape}")
        want = like.dtype if isinstance(like, torch.Tensor) else torch.int32
        if t.dtype != want:
            raise ValueError(f"leaf {i} ({path}): checkpoint dtype "
                             f"{meta['dtype']}, the state holds {want}")
        loaded.append(pl.local(t) if pl is not None and t.dim() else t)
    with torch.no_grad():
        for (path, like), t in zip(leaves, loaded):
            if path == "opt.count":
                state["opt"]["count"] = int(t)
            elif path == "step":
                state["step"] = int(t)
            else:
                like.copy_(t)
    return state, step
