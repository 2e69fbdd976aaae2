"""Costs of one rank's step, counted where the port launches its work (the
counterpart of the reference's ``roofline/hlo_costs.py``).

The reference parses FLOPs, HBM bytes and collective bytes out of the
compiled module's HLO text and multiplies each ``while`` body by its trip
count.  The port has no HLO and no compiled loops: its layer and
microbatch loops are Python loops, so each iteration launches its own
operations, and :func:`count_costs` counts each operation as it launches
(a ``TorchDispatchMode``) — the same on the meta device in a dry run and
on the card's tensors:

* **FLOPs** — ``torch.utils.flop_counter``'s formulas: matmul, bmm,
  addmm, baddbmm, convolutions and the fused attentions (the reference
  counts ``dot`` ops);
* **HBM bytes** — the operand bytes plus the result bytes of each
  operation that launches a kernel (a broadcast dim, stride 0, is read
  once).  Views, reshapes, ``detach``, allocations and metadata queries
  are free, as the reference's ``_FREE_OPS`` are;
* **collective bytes** — by kind (``all-gather``, ``all-reduce``,
  ``broadcast``), from :mod:`repro_torch.nn.sharding`'s collectives
  (:func:`note_collective`): the bytes each call sends, an all-reduce
  twice (the reference's ring convention).  A gather is one broadcast a
  member, and counts as those broadcasts, under ``all-gather``;
* **the hand-written kernels** — each launch is one line at its kernel
  point (``cuda:lut_act_stacked``, ``cuda:wkv``, ...; :func:`note_kernel`,
  called by the wrappers of :mod:`repro_torch.kernels.ops`): its operand
  plus result bytes, as the reference prices a Pallas custom call, plus
  the table bytes it reads through its launch record.  K3 adds its
  product's ``2 M N K`` FLOPs; the reference sees no dot inside a custom
  call.

With ``device`` given, only operations with a tensor on that device type
count (the card's work; host scalars are not its traffic).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# the counters open, innermost last (the wrappers and the collectives find
# this module through sys.modules and note into every one)
_ACTIVE: list["StepCosts"] = []

COLLECTIVES = ("all-gather", "all-reduce", "broadcast")

_aten = torch.ops.aten
# no kernel: allocations, aliases and metadata (views are found by
# their schema, OpOverload.is_view; prim ops are metadata queries, which
# a fake tensor's dispatch shows)
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten._local_scalar_dense.default,
    _aten.set_.source_Storage_storage_offset, _aten.resize_.default,
    _aten.is_same_size.default, _aten.sym_size.int,
    _aten.sym_stride.int, _aten.sym_numel.default,
    _aten.sym_storage_offset.default,
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an operation reads or writes of ``t``: its elements, a
    broadcast (stride-0) dim once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class StepCosts:
    """What a step launched (the fields of the reference's ``HloCosts``;
    ``trip_counts`` stays empty, ``per_comp_*`` are keyed by operation or
    kernel point), plus ``launches`` a kernel point and ``n_ops``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    per_op_coll: dict = dataclasses.field(default_factory=dict)
    trip_counts: dict = dataclasses.field(default_factory=dict)
    per_comp_hbm: dict = dataclasses.field(default_factory=dict)
    per_comp_flops: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0

    def add(self, name: str, nbytes: float, flops: float) -> None:
        self.n_ops += 1
        self.hbm_bytes += nbytes
        self.per_comp_hbm[name] = self.per_comp_hbm.get(name, 0.0) + nbytes
        if flops:
            self.flops += flops
            self.per_comp_flops[name] = (self.per_comp_flops.get(name, 0.0)
                                         + flops)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Counter(TorchDispatchMode):
    def __init__(self, costs: StepCosts, device_type: str | None):
        super().__init__()
        self.costs = costs
        self.device_type = device_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _FREE or func.namespace == "prim":
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self.device_type is not None and not any(
                t.device.type == self.device_type for t in ins + outs):
            return out
        nbytes = sum(tensor_bytes(t) for t in ins + outs)
        formula = flop_registry.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        self.costs.add(str(func._overloadpacket), nbytes, flops)
        return out


@contextlib.contextmanager
def count_costs(device=None):
    """Count the FLOPs, HBM bytes, collective bytes and kernel launches of
    what runs inside into the yielded :class:`StepCosts`; ``device`` (a
    device or its type) keeps the operations that touch it only."""
    dtype = None if device is None else torch.device(device).type
    costs = StepCosts()
    _ACTIVE.append(costs)
    try:
        with _Counter(costs, dtype):
            yield costs
    finally:
        _ACTIVE.remove(costs)


def note_kernel(point: str, reads=(), writes=(), table_bytes: int = 0,
                flops: float = 0) -> None:
    """One launch of a hand-written kernel at ``point``, into every open
    counter: the bytes of the tensors it reads and writes (``None``: an
    absent operand), ``table_bytes`` read through its launch record, and
    ``flops``."""
    nbytes = sum(tensor_bytes(t) for t in (*reads, *writes)
                 if t is not None) + table_bytes
    for c in _ACTIVE:
        c.add(point, nbytes, flops)
        c.launches[point] = c.launches.get(point, 0) + 1


def note_collective(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` (:data:`COLLECTIVES`) sending ``nbytes``
    from this rank, into every open counter (an all-reduce counts twice:
    its reduce-scatter and all-gather halves)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"note_collective: unknown kind {kind!r}")
    moved = nbytes * (2 if kind == "all-reduce" else 1)
    for c in _ACTIVE:
        c.coll_bytes += moved
        c.per_op_coll[kind] = c.per_op_coll.get(kind, 0) + moved
