"""Mesh and placement plumbing for sharded serving and training on
``torch.distributed`` (the port's counterpart of the reference's
``nn/sharding.py``).

The reference annotates tensors with *logical* axes (``"dp"``, the
data-parallel batch; ``"tp"``, the tensor-parallel model dim; ``"fsdp"``;
``None``, replicated) and lets XLA's partitioner place them on a
``(data, model)`` device mesh.  The port runs one process per mesh
position instead (an explicit SPMD program): a :class:`Mesh` is the
layout plus this process's rank and one process group per axis, and a
:class:`Placement` (what :func:`named_sharding` returns) says which dims of
a tensor split over which axes, so a rank can cut its share of a full
tensor (:meth:`Placement.local`) and put the full tensor back together
from the shares (:meth:`Placement.gather`).

The rules are the reference's: ``resolve_axis`` maps a logical axis to
mesh axes, and a dim whose size the axes' product does not divide is
replicated (``_divisible``).  The port serves in the reference's exact
mode (``exact_tp``): its ranks compute at single-device shapes on
gathered weights, so no float reduction is split over the model axis.
Training runs that mode by default too; its ``"partitioned"`` mode (the
reference's GSPMD train step, for every family)
keeps each rank's tp share of the split weights in the compute
(:class:`TPShares`, entered with :func:`use_tp`) and joins the shares
with :func:`copy_to_tp` (identity forward, gradient all-reduced over the
model axis) before a column-parallel product, :func:`reduce_from_tp`
(partial sums all-reduced forward, identity backward) after a
row-parallel one, :func:`gather_from_tp` (a column-parallel product's
columns all-gathered forward, the rank's own slice of the gradient
backward: RWKV6's receptance gate), :func:`gather_to_tp` (a split
activation all-gathered into column-parallel products, its gradient
summed over the model axis before the slice: the recurrent block's
``w_a`` / ``w_x``),
:func:`vocab_parallel_cross_entropy` over vocab-split logits and
:func:`gate_up_exchange` (a gated ``w_in``'s share between its stored
``[gate|up]`` block and the compute's matching columns).  The
collectives the paths need are
here: :func:`gather`, :func:`broadcast`, :func:`all_reduce` (sum or max)
and :func:`each_member` (every member's tensor in rank order, which
training sums in that order).  A gather is one all-gather call where the
group's backend has one for the tensor's device (NCCL on the card, gloo
on the CPU), and one broadcast per member of the axis where it has not
(gloo on the card, whose CUDA support covers broadcast and all-reduce
only: ranks sharing a card); :func:`gather_route` decides from the
backend and the device, never from a failure, and a failed collective
raises.  An NCCL gather can sit inside a captured CUDA graph (the moe
expert gather of :class:`repro_torch.serve.sharded.ShardedServe`'s
captured decode step).  Each call tells
the roofline's cost counter what it sends (:mod:`repro_torch.roofline.
costs`, found through ``sys.modules``); inside the kernels' abstract
route (a dry run on tensors without data,
:mod:`repro_torch.kernels.abstract`) that is all it does: no data moves.

The reference's ``manual_axes``, ``layer_scan`` / ``SCAN_STATS``,
``SEQ_PARALLEL``, ``exact_tp`` and ``spec`` / ``shard`` steer XLA's
partitioner and have no counterpart in an explicit SPMD program (ROADMAP
queue C: sequence parallelism, the dry run's one lever of them, is
skipped there; the ``shard`` constraints of the partitioned train step
are the places :func:`copy_to_tp` and :func:`reduce_from_tp` stand).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import sys
import threading

import torch
import torch.distributed as dist

from repro_torch.kernels.abstract import is_abstract

_STATE = threading.local()

DP_AXES = ("pod", "data")   # data parallelism spans these mesh axes
TP_AXIS = "model"
FSDP_AXIS = "data"          # the ZeRO-3 axis of training (within a pod)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A mesh of ranks, row-major over ``axis_names`` (rank ``r`` of a
    ``(data, model)`` mesh sits at ``(r // tp, r % tp)``, the order of
    ``jax.make_mesh``'s devices).

    Without ``rank`` it is a layout only (placement planning); a mesh
    bound to a process (:func:`repro_torch.launch.mesh.make_host_mesh`)
    has its rank, its device, the collective backend and, per axis, the
    process group of the ranks that share every other coordinate."""

    axis_names: tuple
    sizes: tuple
    rank: int | None = None
    device: torch.device | None = None
    backend: str | None = None
    groups: dict | None = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coords(self, rank: int | None = None) -> dict:
        """``{axis: index}`` of ``rank`` (this process's by default)."""
        r = self.rank if rank is None else rank
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an absent axis)."""
        return self.coords().get(axis, 0)

    def members(self, axis: str, rank: int | None = None) -> list[int]:
        """The global ranks along ``axis`` through ``rank`` (this one's),
        in order of their ``axis`` coordinate."""
        c = self.coords(rank)
        out = []
        for i in range(self.shape.get(axis, 1)):
            c[axis] = i
            r = 0
            for name, n in zip(self.axis_names, self.sizes):
                r = r * n + c[name]
            out.append(r)
        return out

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(
                "Mesh: a layout only (no rank, no process groups); bind one "
                "with repro_torch.launch.mesh.make_host_mesh")
        return self.groups[axis]


def new_axis_groups(mesh: Mesh) -> dict:
    """One process group per axis for every rank of ``mesh`` (every rank
    must call this, in the same order): ``{axis: the group of this
    rank}``."""
    groups = {}
    for axis in mesh.axis_names:
        seen = set()
        for r in range(mesh.size):
            ranks = tuple(mesh.members(axis, r))
            if ranks in seen:
                continue
            seen.add(ranks)
            g = dist.new_group(list(ranks))
            if mesh.rank in ranks:
                groups[axis] = g
    return groups


def current_mesh() -> Mesh | None:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def resolve_axis(logical: str | None, mesh):
    """Map a logical axis name to mesh axes (``None`` if not shardable)."""
    if logical is None or mesh is None:
        return None
    if logical == "dp":
        axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
        return axes if axes else None
    if logical == "tp":
        return TP_AXIS if TP_AXIS in mesh.axis_names else None
    if logical == "fsdp":
        return FSDP_AXIS if FSDP_AXIS in mesh.axis_names else None
    if logical == "sp":
        return None   # sequence parallelism is not ported
    raise ValueError(f"unknown logical axis {logical!r}")


def _axes_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _divisible(dim: int, mesh, axes) -> bool:
    n = 1
    for a in _axes_tuple(axes):
        n *= mesh.shape[a]
    return dim % n == 0


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which mesh axes each dim of a tensor splits over (``spec``, one
    entry per dim: ``None``, an axis name or a tuple of names)."""

    mesh: Mesh
    spec: tuple

    def parts(self, dim: int) -> int:
        return math.prod(self.mesh.shape[a]
                         for a in _axes_tuple(self.spec[dim]))

    @property
    def replicated(self) -> bool:
        return all(self.parts(i) == 1 for i in range(len(self.spec)))

    def local_shape(self, shape) -> tuple:
        return tuple(n // self.parts(i) for i, n in enumerate(shape))

    def _block(self, dim: int) -> int:
        """This rank's block index along ``dim`` (row-major over the
        dim's axes)."""
        b = 0
        for a in _axes_tuple(self.spec[dim]):
            b = b * self.mesh.shape[a] + self.mesh.index(a)
        return b

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's share of ``full``, a contiguous copy."""
        out = full
        for i in range(len(self.spec)):
            n = self.parts(i)
            if n > 1:
                size = full.shape[i] // n
                out = out.narrow(i, self._block(i) * size, size)
        return out.contiguous() if out is full else out.clone(
            memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor, keep: tuple = ()) -> torch.Tensor:
        """The full tensor from every rank's share (collective over each
        split dim's axes: every rank of those groups must call it).  Axes
        in ``keep`` stay split: a dim split over ``keep`` only is left as
        this rank's share (training keeps the moe expert stacks, and a
        partitioned step every leaf it splits, split over the model axis
        through the compute)."""
        out = local
        for i in range(len(self.spec)):
            axes = _axes_tuple(self.spec[i])
            if any(a in keep for a in axes):
                if not all(a in keep for a in axes):
                    raise ValueError(f"Placement.gather: dim {i} splits over "
                                     f"{axes}; keep all or none of them")
                continue
            # the inner axis first: its blocks are the finest
            for a in reversed(axes):
                out = gather(out, self.mesh, a, dim=i)
        return out

    def only(self, axes: tuple) -> "Placement":
        """This placement with every split but those over ``axes``
        dropped (replicated)."""
        return Placement(self.mesh, tuple(
            s if any(a in axes for a in _axes_tuple(s)) else None
            for s in self.spec))


def named_sharding(mesh: Mesh, *logical_axes: str | None,
                   shape: tuple | None = None) -> Placement:
    """The placement of a tensor annotated with ``logical_axes`` on
    ``mesh`` (the reference's ``PartitionSpec`` as ``spec``), a dim that
    ``shape`` says does not divide replicated."""
    resolved = []
    for i, a in enumerate(logical_axes):
        r = resolve_axis(a, mesh)
        if shape is not None and not _divisible(shape[i], mesh, r):
            r = None
        resolved.append(r)
    return Placement(mesh, tuple(resolved))


# -------------------------------------------------------------------------
# collectives
# -------------------------------------------------------------------------
def _sent(kind: str, t: torch.Tensor) -> bool:
    """Tell the cost counter about one collective of ``kind`` over ``t``;
    False inside the abstract route, where nothing is sent."""
    costs = sys.modules.get("repro_torch.roofline.costs")
    if costs is not None and costs._ACTIVE:
        costs.note_collective(kind, t.numel() * t.element_size())
    return not is_abstract()


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src_index: int,
              kind: str = "broadcast") -> torch.Tensor:
    """Broadcast ``t`` (contiguous, in place) from the rank at ``axis``
    coordinate ``src_index`` to every rank along ``axis``, as bytes (any
    dtype, every bit kept); ``kind``: what the cost counter files it
    under (a gather's broadcasts are an ``"all-gather"``)."""
    if mesh.shape.get(axis, 1) > 1 and t.numel() and _sent(kind, t):
        dist.broadcast(t.reshape(-1).view(torch.uint8),
                       src=mesh.members(axis)[src_index],
                       group=mesh.group(axis))
    return t


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str | None = None,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` (contiguous, in place) over ``axis`` (every rank when
    ``None``) by ``op``: ``"sum"`` or ``"max"``."""
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if axis is None:
        if mesh.size > 1 and _sent("all-reduce", t):
            dist.all_reduce(t, op=rop)
    elif mesh.shape.get(axis, 1) > 1 and _sent("all-reduce", t):
        dist.all_reduce(t, op=rop, group=mesh.group(axis))
    return t


def all_ranks_ok(mesh: Mesh, ok: bool) -> bool:
    """True on every rank when ``ok`` holds on every rank (an all-reduce
    of the failures)."""
    dev = mesh.device or torch.device("cpu")
    bad = torch.tensor([0 if ok else 1], dtype=torch.int32, device=dev)
    return int(all_reduce(bad, mesh)) == 0


def each_member(t: torch.Tensor, mesh: Mesh, axes: tuple):
    """Every rank's ``t`` along ``axes`` (row-major over them, the order
    of their ranks), one at a time in one buffer: member ``(i, j)`` is
    broadcast over the inner axis from ``j`` (each rank at inner index
    ``j`` sends its own) and then over the outer from ``i``.  The buffer
    is reused: use each member before asking for the next.  Every rank of
    those groups must run the loop to its end."""
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        yield t
        return
    me = tuple(mesh.index(a) for a in axes)
    buf = torch.empty_like(t, memory_format=torch.contiguous_format)
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        if me[-1] == idx[-1]:
            buf.copy_(t)
        for k in reversed(range(len(axes))):
            broadcast(buf, mesh, axes[k], idx[k])
        yield buf


def gather_route(backend: str, device_type: str) -> str:
    """How :func:`gather` moves a tensor on ``device_type`` over a group
    of ``backend``: ``"broadcasts"``, one a member, where the backend has
    no all-gather for that device (gloo on the card: its CUDA support
    covers broadcast and all-reduce only), else ``"all_gather"``, one
    call (NCCL on the card, gloo on the CPU)."""
    if backend == "gloo" and device_type == "cuda":
        return "broadcasts"
    return "all_gather"


def _all_gather():
    # all_gather_single is the newer name (all_gather_into_tensor is
    # deprecated where both exist); older torch has only the second
    if hasattr(dist, "all_gather_single"):
        return dist.all_gather_single
    return dist.all_gather_into_tensor


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def gather_into(out: torch.Tensor, t: torch.Tensor, mesh: Mesh,
                axis: str) -> torch.Tensor:
    """Fill ``out`` (contiguous, its dim 0 the ``n`` members' blocks of
    ``t``'s shape, in the order of their ``axis`` coordinate) with every
    rank's ``t`` along ``axis``, as bytes, so every bit arrives as it was
    sent: one all-gather or one broadcast a member, by
    :func:`gather_route`.  Every rank of the group must call it."""
    n = mesh.shape[axis]
    group = mesh.group(axis)
    if gather_route(dist.get_backend(group), t.device.type) == "all_gather":
        if t.numel() and _sent("all-gather", out):
            _all_gather()(_as_bytes(out), _as_bytes(t.contiguous()),
                          group=group)
        return out
    blocks = out.view((n, *t.shape))
    me = mesh.index(axis)
    for j in range(n):
        if j == me:
            blocks[j].copy_(t)
        broadcast(blocks[j], mesh, axis, j, kind="all-gather")
    return out


def gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0
           ) -> torch.Tensor:
    """Every rank's ``t`` along ``axis`` concatenated along ``dim``, in
    the order of their coordinate (a negative ``dim`` counts from the
    end), through a ``(n, *t.shape)`` buffer (:func:`gather_into`)."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return t
    dim %= t.dim()
    buf = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    gather_into(buf, t, mesh, axis)
    return buf.movedim(0, dim).flatten(dim, dim + 1)


def exchange(send: dict, recv_from: list, mesh: Mesh, axis: str) -> list:
    """Blocks between the ranks along ``axis`` in one all-to-all:
    ``send`` maps a member's coordinate to the block this rank sends it
    (all of one shape and dtype), ``recv_from`` the coordinates this rank
    receives from, one block each, in the order returned.  Every rank of
    the group must call it; each pair of ranks carries at most one block.
    Gloo on the card stages the bytes through the host."""
    like = next(iter(send.values()))
    nbytes = like.numel() * like.element_size()
    if len(set(recv_from)) != len(recv_from):
        raise ValueError(f"exchange: a source twice in {recv_from}")
    n = mesh.shape[axis]
    inp = torch.cat([_as_bytes(send[d].contiguous()) for d in sorted(send)])
    out = torch.empty(len(recv_from) * nbytes, dtype=torch.uint8,
                      device=like.device)
    if _sent("all-to-all", inp):
        group = mesh.group(axis)
        splits_in = [nbytes if d in send else 0 for d in range(n)]
        splits_out = [nbytes if s in recv_from else 0 for s in range(n)]
        if gather_route(dist.get_backend(group),
                        like.device.type) == "broadcasts":
            # gloo on the card: through host copies, as gloo makes of a
            # card tensor anyway
            got = torch.empty(out.shape, dtype=out.dtype)
            dist.all_to_all_single(got, inp.cpu(), splits_out, splits_in,
                                   group=group)
            out.copy_(got)
        else:
            dist.all_to_all_single(out, inp, splits_out, splits_in,
                                   group=group)
    by_src = dict(zip(sorted(recv_from), out.split(nbytes)))
    return [by_src[s].view(like.dtype).view(like.shape) for s in recv_from]


# -------------------------------------------------------------------------
# partitioned tensor parallelism (the partitioned train step)
# -------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPShares:
    """What a rank of a partitioned train step keeps as its share over
    the model axis through the compute: the dotted names of those leaves
    (``split``; every other leaf is whole), and among them the gated
    ``w_in`` and ``sh_w_in`` stacks, held in the compute's ``[gate_i |
    up_i]`` layout (``gate_up``, :func:`gate_up_exchange`)."""

    mesh: Mesh
    split: frozenset
    gate_up: frozenset = frozenset()

    @property
    def size(self) -> int:
        return self.mesh.shape.get(TP_AXIS, 1)

    @property
    def index(self) -> int:
        return self.mesh.index(TP_AXIS)

    def splits(self, name: str) -> bool:
        return name in self.split


def current_tp() -> TPShares | None:
    return getattr(_STATE, "tp", None)


@contextlib.contextmanager
def use_tp(shares: TPShares | None):
    """Run the model on the rank's tp shares (``None``: whole weights)."""
    prev = current_tp()
    _STATE.tp = shares
    try:
        yield
    finally:
        _STATE.tp = prev


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return all_reduce(g, ctx.mesh, TP_AXIS), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          mesh, TP_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_mesh() -> Mesh | None:
    mesh = current_mesh()
    if mesh is None or mesh.shape.get(TP_AXIS, 1) == 1:
        return None
    return mesh


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """``x`` into a column-parallel product (or a replicated parameter
    into the rank's part of the compute): the identity forward, its
    gradient, a partial sum on each rank, all-reduced over the model axis
    backward.  Through :func:`all_reduce`, so over gloo and NCCL alike;
    a group that cannot all-reduce raises."""
    mesh = _tp_mesh()
    return x if mesh is None else _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums (or a vocab-split lookup's),
    all-reduced over the model axis forward; the identity backward."""
    mesh = _tp_mesh()
    return x if mesh is None else _ReduceFromTP.apply(x, mesh)


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return gather(x, mesh, TP_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.mesh.index(TP_AXIS), ctx.width
        return g[..., i * w:(i + 1) * w], None


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel product's output (split over the model axis on
    its last dim) made whole: every rank's columns in rank order, one
    all-gather forward (:func:`gather`: one call on NCCL, broadcasts on
    gloo; a group that cannot gather raises); the rank's own slice of the
    gradient backward, which every model rank holds whole."""
    mesh = _tp_mesh()
    return x if mesh is None else _GatherFromTP.apply(x, mesh)


class _GatherToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return gather(x, mesh, TP_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.mesh.index(TP_AXIS), ctx.width
        g = all_reduce(g.clone(memory_format=torch.contiguous_format),
                       ctx.mesh, TP_AXIS)
        return g[..., i * w:(i + 1) * w], None


def gather_to_tp(x: torch.Tensor) -> torch.Tensor:
    """A tensor split over the model axis on its last dim made whole as
    the input of column-parallel products: every rank's columns in rank
    order, one all-gather forward (:func:`gather`); backward, each rank's
    gradient of the whole tensor is a partial sum (its own columns of the
    products' weights), so it is all-reduced over the model axis before
    the rank takes its slice.  The recurrent block's conv output into
    ``w_a`` / ``w_x`` (:func:`repro_torch.nn.rglru.recurrent_block`).
    Where every rank uses the gathered tensor whole and alike (RWKV6's
    receptance gate), :func:`gather_from_tp` is the one: its gradient is
    already whole on each rank, and summing it would count it ``tp``
    times."""
    mesh = _tp_mesh()
    return x if mesh is None else _GatherToTP.apply(x, mesh)


def vocab_parallel_cross_entropy(local_logits: torch.Tensor,
                                 labels: torch.Tensor,
                                 vocab_start: int) -> torch.Tensor:
    """Mean cross-entropy over logits split by vocab over the model axis
    (this rank's columns ``vocab_start ..``), in float32: the max over the
    axis first, then the sum of exps, each reduced over it; the picked
    logit from the rank that owns the label, summed over the axis; then
    ``mean(lse - picked)``, the order of
    :func:`~repro_torch.nn.layers.softmax_cross_entropy`."""
    mesh = _tp_mesh()
    logits = local_logits.float()
    m = torch.amax(logits.detach(), dim=-1).contiguous()
    if mesh is not None:
        all_reduce(m, mesh, TP_AXIS, op="max")
    lse = m + torch.log(reduce_from_tp(torch.sum(
        torch.exp(logits - m[..., None]), dim=-1)))
    idx = labels.long() - vocab_start
    mine = (idx >= 0) & (idx < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(mine, idx, 0)[..., None])
    picked = torch.where(mine, picked[..., 0], 0.0)
    return torch.mean(lse - reduce_from_tp(picked))


def gate_up_exchange(t: torch.Tensor, mesh: Mesh, inverse: bool = False
                     ) -> torch.Tensor:
    """A gated ``w_in`` share (``(..., S)``, split over the model axis on
    its last dim) between the layout it is stored in and the compute's.
    Stored, rank ``j`` holds columns ``j S .. (j + 1) S`` of the whole
    ``[gate | up]`` (at tp 2 one rank all of ``gate``, the other all of
    ``up``); the compute needs ``[gate_i | up_i]``, the ``i``-th
    ``1 / tp`` of each.  With ``s = S / 2``, half-block ``k`` of the whole
    (``k < tp``: ``gate_k``, else ``up_{k - tp}``) is stored on rank
    ``k // 2`` and computed on rank ``k % tp``, so a rank sends its two
    halves and receives two: one all-to-all moving one share's bytes
    (:func:`exchange`), never the whole leaf.  ``inverse``: the compute
    layout back to the stored one (a gradient on the way out)."""
    n = mesh.shape.get(TP_AXIS, 1)
    if n == 1:
        return t
    i = mesh.index(TP_AXIS)
    halves = t.chunk(2, dim=-1)
    if inverse:
        send = {i // 2: halves[0], (n + i) // 2: halves[1]}
        recv = [(2 * i) % n, (2 * i + 1) % n]
    else:
        send = {(2 * i) % n: halves[0], (2 * i + 1) % n: halves[1]}
        recv = [i // 2, (n + i) // 2]
    return torch.cat(exchange(send, recv, mesh, TP_AXIS), dim=-1)
