"""Mesh-aware serving on ``torch.distributed`` (the port's counterpart of
the reference's ``serve/sharded.py``): the table placement policy, the
parameter and decode-state placements, and the sharded steps.

One process serves each position of a ``(data, model)`` mesh
(:mod:`repro_torch.launch.mesh`).  The contract is the reference's
**bit-identity with the single-device program**: a data rank's logits, and
so every greedy token, are bit for bit those of the single-device program
on that rank's rows.  Three pieces:

* **Table placement** (:class:`PlacementPolicy`, :func:`place_tables`) —
  small per-site tables are replicated (each rank builds its copy from
  the same plans); a stacked ``(L, …)`` slab of at least
  ``shard_threshold_bytes`` whose layer count the data axis divides is
  split by layer over the data axis.  A rank keeps its ``L / dp`` layers,
  and the step gathers the slab into a buffer allocated once, which the
  evaluators index by layer (K1's launch record points at that buffer, so
  it stays valid).  Tables are integer data, so the split is exact.  The
  buffer stays resident, so a rank holds ``(1 + 1/dp)`` of a split slab:
  more than a replicated one.  The split saves no memory in the port, and
  the placement report counts what a rank holds.  The multi-site
  super-slab of K4 (``kernel="fused"``) is the single-device fast path
  and is refused.

* **Parameter and state placement** (:func:`serve_param_shardings`,
  :func:`serve_cache_shardings`, :func:`init_params_sharded`) — every
  ``"tp"`` axis of :func:`~repro_torch.nn.transformer.param_defs` is split
  at rest (1/|model| of those weights a rank), and the step gathers every
  weight but the moe expert stacks (an all-gather loses no bits; a
  row-parallel product's partial-sum all-reduce would change the float
  order, so none runs).  The expert stacks stay split through the compute
  (:mod:`repro_torch.nn.moe`).  The decode state and the batch split over
  the data axis only.

* **The sharded steps** (:class:`ShardedServe`) — prefill, decode and
  prefill replay on a rank's rows, in one of the reference's two modes:
  ``"gspmd"`` (the default: policy-placed tables, replay served) or
  ``"shard_map"`` (every slab replicated, replay refused).  Both run the
  same explicit program here, the moe experts split over the model axis
  in both; the modes keep the reference's meanings.  A step gathers
  the weights at its entry; :meth:`ShardedServe.session` holds one gather
  over several steps (a batcher tick, or the launcher's prefill and
  decode loop), into buffers allocated once and refilled by every
  session.  Where the ranks have a card each and NCCL
  (:mod:`repro_torch.launch.mesh`), :meth:`ShardedServe.decode_fn` hands
  out the decode step captured in a CUDA graph over those buffers
  (:class:`ShardedCapturedStep`; a moe step's expert all-gathers inside
  it), replayed across sessions; gloo collectives cannot be captured, so
  ranks sharing a card step eagerly.  Over gloo on a shared card a
  gather of qwen3-0.6b's weights takes about a second (PERF.md §6).

The reference's ``split_table_operands`` and ``lower_decode`` serve
``jax.jit`` and have no counterpart: the dry run
(:mod:`repro_torch.launch.dryrun`) traces :class:`ShardedServe`'s own
steps in place of a lowering (ROADMAP queue C).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.sharding import (
    DP_AXES,
    TP_AXIS,
    Mesh,
    Placement,
    gather,
    gather_into,
    named_sharding,
    use_mesh,
)
from repro_torch.nn.transformer import (
    _flat_defs,
    draw_params,
    param_defs,
    params_class,
    torch_dtype,
)

from .graphs import CapturedStep

MODES = ("gspmd", "shard_map")
# the shard_map mode's threshold: every slab replicated
REPLICATE_ALL = 1 << 62


# =========================================================================
# table placement
# =========================================================================
@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """When to split a stacked ``(L, …)`` table slab by layer instead of
    replicating it: at ``shard_threshold_bytes`` and above, over
    ``layer_axis`` (the data axis; the model axis stays free for the
    experts and the weights)."""

    shard_threshold_bytes: int = 1 << 20
    layer_axis: str = "data"


def _arrays_nbytes(tree) -> int:
    """Bytes of every array (tensor or numpy) in a nested dict / list."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(_arrays_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_arrays_nbytes(v) for v in tree)
    return 0


def _sharded_bytes(n_bytes: int, n_axis: int) -> int:
    """Bytes a rank holds of a layer-sharded slab: its share and the
    resident full-size buffer."""
    return n_bytes + -(-n_bytes // n_axis)


def _entry_placement(entry: dict, mesh, policy: PlacementPolicy):
    """-> (placement label, total bytes, bytes a rank holds)."""
    n_bytes = _arrays_nbytes(entry)
    if "stacked" in entry and mesh is not None:
        n_layers = entry["stacked"]["meta"]["n_layers"]
        n_axis = int(mesh.shape.get(policy.layer_axis, 1))
        if (n_axis > 1 and n_bytes >= policy.shard_threshold_bytes
                and n_layers % n_axis == 0):
            return "layer_sharded", n_bytes, _sharded_bytes(n_bytes, n_axis)
    return "replicated", n_bytes, n_bytes


def _slab_tensors(st: dict) -> dict:
    """The ``(L, …)`` tensors of a stacked entry, by name."""
    out = {f"arrays.{c}": t for c, t in st["arrays"].items()}
    out["meta_i"], out["meta_f"] = st["meta_i"], st["meta_f"]
    return out


@dataclasses.dataclass
class LayerShardedSlab:
    """A layer-sharded stacked entry: this rank's layers (``shard``) and
    the full-size buffer the step gathers them into (``entry``, what the
    evaluators read)."""

    site: str
    axis: str
    entry: dict
    shard: dict

    def gather_into_buffer(self, mesh: Mesh) -> None:
        """Fill the buffer from every data rank's layers, each into its
        block of rows: one gather a tensor (:func:`~repro_torch.nn.
        sharding.gather_into`)."""
        bufs = _slab_tensors(self.entry)
        for name, shard in self.shard.items():
            gather_into(bufs[name], shard, mesh, self.axis)


def place_tables(lut_tables: dict | None, mesh,
                 policy: PlacementPolicy | None = None):
    """Place every site entry per the policy: ``(placed tables, report,
    layer-sharded slabs)``, the report ``{site: {"placement", "bytes",
    "per_device_bytes"}}``.  A replicated entry passes through as it is
    (this rank's copy); a layer-sharded one keeps this rank's layers and
    gets a new full-size buffer, empty until a step gathers it.  Tables
    built for K4 (``kernel="fused"``) are refused."""
    if lut_tables is None or mesh is None:
        return lut_tables, {}, []
    if lut_tables.get("kernel") == "fused" or "multi" in lut_tables:
        raise ValueError(
            "place_tables: kernel='fused' is the single-device fast path — "
            "under a mesh every site goes through K1 / K2 (build the "
            "tables with kernel='isolated')")
    policy = policy or PlacementPolicy()
    report, sites, slabs = {}, {}, []
    for site, entry in lut_tables.get("sites", {}).items():
        placement, n_bytes, per_dev = _entry_placement(entry, mesh, policy)
        placed = entry.get("stacked", {}).get("layer_shard")
        if placed is not None:
            # placed before (tables_for_model(mesh=...)): keep its split,
            # or gather it once where the policy replicates
            if policy.shard_threshold_bytes < REPLICATE_ALL:
                placement, per_dev = "layer_sharded", _sharded_bytes(
                    n_bytes, mesh.shape[placed.axis])
                slabs.append(placed)
                sites[site] = entry
            else:
                placed.gather_into_buffer(mesh)
                sites[site] = {"stacked": {k: v for k, v in
                                           entry["stacked"].items()
                                           if k != "layer_shard"}}
            report[site] = {"placement": placement, "bytes": n_bytes,
                            "per_device_bytes": per_dev}
            continue
        report[site] = {"placement": placement, "bytes": n_bytes,
                        "per_device_bytes": per_dev}
        if placement != "layer_sharded":
            sites[site] = entry
            continue
        st = entry["stacked"]
        n = mesh.shape[policy.layer_axis]
        me = mesh.index(policy.layer_axis)
        shard = {}
        for name, t in _slab_tensors(st).items():
            blk = t.shape[0] // n
            shard[name] = t[me * blk:(me + 1) * blk].clone()
        buf = {"meta": st["meta"],
               "arrays": {c: torch.empty_like(t)
                          for c, t in st["arrays"].items()},
               "meta_i": torch.empty_like(st["meta_i"]),
               "meta_f": torch.empty_like(st["meta_f"])}
        if buf["meta_i"].device.type != "cpu":
            from repro_torch.kernels.lut_act import stacked_record

            buf["k1_record"] = stacked_record(buf)
        slab = LayerShardedSlab(site, policy.layer_axis, buf, shard)
        buf["layer_shard"] = slab
        sites[site] = {"stacked": buf}
        slabs.append(slab)
    placed = dict(lut_tables, sites=sites)
    return placed, report, slabs


def plan_placement_report(lut_tables: dict | None, mesh,
                          policy: PlacementPolicy | None = None) -> dict:
    """Placement accounting without moving any data: per-site decisions
    and the replicated / layer-sharded / per-rank byte totals, the last
    what a rank holds (a layer-sharded slab's share and its buffer)."""
    if not lut_tables:
        return {"sites": {}, "replicated_bytes": 0, "sharded_bytes": 0,
                "per_device_bytes": 0}
    policy = policy or PlacementPolicy()
    sites = {}
    rep_b = shard_b = per_dev = 0
    for site, entry in lut_tables.get("sites", {}).items():
        placement, n_bytes, pd = _entry_placement(entry, mesh, policy)
        sites[site] = {"placement": placement, "bytes": n_bytes,
                       "per_device_bytes": pd}
        per_dev += pd
        if placement == "layer_sharded":
            shard_b += n_bytes
        else:
            rep_b += n_bytes
    return {"sites": sites, "replicated_bytes": rep_b,
            "sharded_bytes": shard_b, "per_device_bytes": per_dev}


def tables_checksum(lut_tables: dict | None) -> str:
    """SHA-256 over every table tensor's bytes, in key order: equal on
    every rank that holds the same tables."""
    h = hashlib.sha256()

    def walk(obj, key=""):
        if isinstance(obj, torch.Tensor):
            h.update(key.encode())
            h.update(obj.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        elif isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k], f"{key}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{key}[{i}]")

    walk(lut_tables)
    return h.hexdigest()


# =========================================================================
# parameter / state placement
# =========================================================================
# Expert-parallel weight stacks: "tp" sits on the expert dim, which is
# exact to split (each expert's product is local to one rank).
_EXPERT_PARAMS = ("moe_w_in", "moe_w_out")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def serve_param_shardings(cfg: ArchConfig, mesh) -> dict:
    """``{dotted name: Placement}`` of every parameter at rest: every
    ``"tp"`` axis of ``param_defs`` kept (a dim the model axis does not
    divide replicated), ``"fsdp"`` dropped (no ZeRO-3 gathers on the
    decode path)."""
    out = {}
    for name, d, _ in _flat_defs(param_defs(cfg)):
        axes = d.axes or (None,) * len(d.shape)
        out[name] = named_sharding(
            mesh, *[None if a == "fsdp" else a for a in axes],
            shape=d.shape)
    return out


def _state_axes(name: str, ndim: int) -> tuple:
    """Logical axes of one decode-state leaf: the batch over dp only (a
    split sequence dim would reorder the attention's float sums)."""
    if name in ("k", "v", "xk", "xv"):           # (L|G, B, T, KV, Dh)
        return (None, "dp", None, None, None)
    if name in ("k_scale", "v_scale"):           # (L, B, T, KV)
        return (None, "dp", None, None)
    if name == "wkv":                            # (L, B, H, N, N)
        return (None, "dp", None, None, None)
    if name in ("att_x", "ffn_x"):               # (L, B, 1, d)
        return (None, "dp", None, None)
    if name == "conv":                           # (..., B, K-1, drnn)
        return (None,) * (ndim - 3) + ("dp", None, None)
    if name == "lru":                            # (..., B, drnn)
        return (None,) * (ndim - 2) + ("dp", None)
    return (None,) * ndim


def _map_state(state: dict, fn):
    return {k: _map_state(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in state.items()}


def serve_cache_shardings(cfg: ArchConfig, mesh, batch: int, max_seq: int,
                          kv_dtype: str = "bfloat16") -> dict:
    """The decode state's placements (batch over dp only), in the nesting
    of :func:`~repro_torch.serve.kvcache.init_cache`."""
    from .kvcache import init_cache

    specs = init_cache(cfg, batch, max_seq, device="meta",
                       kv_dtype="int8" if kv_dtype == "int8" else None)
    return _map_state(specs, lambda name, leaf: named_sharding(
        mesh, *_state_axes(name, leaf.dim()), shape=tuple(leaf.shape)))


def batch_placement(mesh, batch: dict) -> dict:
    """This rank's rows of a prefill batch dict (dim 0 over dp)."""
    return {k: named_sharding(mesh, "dp", *(None,) * (v.dim() - 1),
                              shape=tuple(v.shape)).local(v)
            for k, v in batch.items()}


def gather_rows(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``t`` along ``dim``, in rank order (the
    inverse of :func:`batch_placement`)."""
    for a in reversed([a for a in DP_AXES if a in mesh.axis_names]):
        t = gather(t, mesh, a, dim=dim)
    return t


def _local_params(cfg: ArchConfig, leaves: dict, device):
    return params_class(cfg)(cfg, device, leaves=leaves)


def shard_params(params, cfg: ArchConfig, mesh):
    """This rank's shares of full ``params`` (a new params object; the
    caller may free the full one)."""
    pl = serve_param_shardings(cfg, mesh)
    leaves = {n: pl[n].local(p.detach())
              for n, p in params.named_parameters()}
    return _local_params(cfg, leaves, params.embed.device)


def init_params_sharded(cfg: ArchConfig, seed: int, mesh, device,
                        placements: dict | None = None):
    """This rank's shares of :func:`~repro_torch.nn.init_params`'s
    parameters, drawn leaf by leaf (a stack layer by layer) with the same
    generator, so the shares hold the single-device bits and no rank ever
    holds the whole model: each draw is cut to this rank's share and
    dropped.  ``placements``: ``{dotted name: Placement}``, serving's
    (:func:`serve_param_shardings`) by default."""
    pl = placements or serve_param_shardings(cfg, mesh)
    dt = torch_dtype(cfg.dtype)
    leaves = {}
    for name, d, stacked in _flat_defs(param_defs(cfg)):
        leaves[name] = torch.empty(pl[name].local_shape(d.shape), dtype=dt,
                                   device=device)
    with torch.no_grad():
        for name, i, v in draw_params(cfg, seed, device):
            t = leaves[name]
            if v is None:
                t.zero_()
            elif i is None:
                t.copy_(pl[name].local(v))
            else:
                part = Placement(mesh, pl[name].spec[1:])
                t[i].copy_(part.local(v))
    return _local_params(cfg, leaves, device)


# =========================================================================
# the sharded steps
# =========================================================================
class ShardedServe:
    """Sharded prefill / decode / replay for one ``(cfg, mesh, tables)``
    on this rank: ``mode="gspmd"`` (the default) or ``"shard_map"``
    (every slab replicated, no replay), the reference's two modes.  Parameters, batch and cache are this rank's
    (:meth:`place_params`, :meth:`place_batch`, :meth:`place_cache`);
    logits come back for this rank's rows."""

    def __init__(self, cfg: ArchConfig, mesh, lut_tables: dict | None = None,
                 *, mode: str = "gspmd",
                 policy: PlacementPolicy | None = None,
                 kv_dtype: str = "bfloat16"):
        if mode not in MODES:
            raise ValueError(
                f"ShardedServe: unknown mode {mode!r} "
                f"(expected 'gspmd' or 'shard_map')")
        self.cfg = cfg
        self.mesh = mesh
        self.mode = mode
        self.kv_dtype = kv_dtype
        if mode == "shard_map":
            policy = PlacementPolicy(shard_threshold_bytes=REPLICATE_ALL)
        self.policy = policy or PlacementPolicy()
        self.tables, self.placement, self._slabs = place_tables(
            lut_tables, mesh, self.policy)
        self._param_pl = serve_param_shardings(cfg, mesh)
        self._full = None   # the gathered weights inside a session
        self._held = None   # the params object over the held buffers
        self._held_key = None   # the parameters' pointers it was made for
        self._held_leaves = {}  # dotted name -> held gathered buffer
        self.gather_s = None   # the last session's gather, seconds

    # -- placement helpers -------------------------------------------------
    def place_params(self, params):
        """This rank's shares of ``params`` (full ones are cut; shares
        pass through)."""
        if self._is_full(params):
            return shard_params(params, self.cfg, self.mesh)
        return params

    def _is_full(self, params) -> bool:
        named = dict(params.named_parameters())
        return all(tuple(named[n].shape) == d.shape
                   for n, d, _ in _flat_defs(param_defs(self.cfg)))

    def place_batch(self, batch: dict) -> dict:
        return batch_placement(self.mesh, batch)

    def place_cache(self, cache: dict) -> dict:
        return _map_state(cache, lambda name, leaf: named_sharding(
            self.mesh, *_state_axes(name, leaf.dim()),
            shape=tuple(leaf.shape)).local(leaf))

    # -- the step's entry --------------------------------------------------
    def gather_weights(self, params):
        """The weights a step computes with: every parameter but the
        expert stacks gathered over the model axis (a collective: every
        rank of the mesh calls it) into buffers allocated at the first
        call and refilled in place by every later one, so the same params
        object comes back and a step captured over it replays after each
        gather.  Other ``params`` (other tensors) get new buffers."""
        named = list(params.named_parameters())
        key = tuple(p.data_ptr() for _, p in named)
        if key != self._held_key:
            self._held, self._held_key, self._held_leaves = None, key, {}
        leaves = {}
        for name, p in named:
            pl = self._param_pl[name]
            if _leaf(name) in _EXPERT_PARAMS or pl.replicated:
                leaves[name] = p.detach()
            elif name in self._held_leaves:
                self._held_leaves[name].copy_(pl.gather(p.detach()))
            else:
                leaves[name] = self._held_leaves[name] = pl.gather(
                    p.detach())
        if self._held is None:
            self._held = _local_params(self.cfg, leaves, params.embed.device)
        return self._held

    @contextlib.contextmanager
    def session(self, params):
        """Gather the weights and the layer-sharded slabs once for every
        step inside (a batcher tick: its step calls and replays).  Outside
        a session each call gathers at its own entry."""
        if self._full is not None:
            yield self._full
            return
        with use_mesh(self.mesh):
            t0 = time.perf_counter()
            for slab in self._slabs:
                slab.gather_into_buffer(self.mesh)
            self._full = self.gather_weights(params)
            if self._full.embed.device.type == "cuda":
                torch.cuda.synchronize(self._full.embed.device)
            self.gather_s = time.perf_counter() - t0
            try:
                yield self._full
            finally:
                self._full = None

    def decode_fn(self, params, pool=None):
        """The decode step a serving loop calls inside :meth:`session`,
        ``(cache, tokens, pos) -> (logits, cache)``: a
        :class:`ShardedCapturedStep` (into ``pool`` when given) where the
        mesh runs NCCL on the card, the eager sharded step where it runs
        gloo or on the CPU (:func:`capture_refusal` says why)."""
        if capture_refusal(self.mesh) is None:
            return ShardedCapturedStep(self, pool=pool)
        return lambda cache, tokens, pos: self.decode(params, cache, tokens,
                                                      pos)

    # -- public API --------------------------------------------------------
    def prefill(self, params, batch: dict, max_seq: int):
        from .decode import prefill

        with self.session(params) as full:
            return prefill(full, self.cfg, batch, max_seq=max_seq,
                           lut_tables=self.tables)

    def decode(self, params, cache, tok, pos):
        from .decode import decode_step

        with self.session(params) as full:
            return decode_step(full, self.cfg, cache, tok, pos,
                               lut_tables=self.tables)

    def replay(self, params, cache, tokens, start_pos: int = 0):
        from .decode import decode_step, prefill_replay

        if self.mode != "gspmd":
            raise NotImplementedError(
                "prefill replay is served in gspmd mode only")
        with self.session(params) as full:
            step = lambda c, tk, pos: decode_step(
                full, self.cfg, c, tk, pos, lut_tables=self.tables)
            return prefill_replay(full, self.cfg, cache, tokens, start_pos,
                                  self.tables, step=step)


def capture_refusal(mesh) -> str | None:
    """Why this rank's sharded decode step cannot be captured in a CUDA
    graph, or ``None`` when it can: a graph runs on the card and can hold
    an NCCL collective, not a gloo one."""
    why = []
    if mesh.backend != "nccl":
        why.append(f"the mesh's collective backend is {mesh.backend} (a "
                   f"CUDA graph holds NCCL collectives only)")
    dev = torch.device(mesh.device or "cpu")
    if dev.type != "cuda":
        why.append(f"the rank serves on {dev} (CUDA graphs run on the "
                   f"card)")
    return "; ".join(why) or None


class ShardedCapturedStep(CapturedStep):
    """The sharded decode step as a replayed CUDA graph, where the mesh
    runs NCCL on the card: :func:`~repro_torch.serve.decode.decode_step`
    over a :class:`ShardedServe`'s held weights, called inside its
    :meth:`~ShardedServe.session` like the eager step, and captured once
    per cache and batch (every session refills the same buffers).  A
    dense model runs no collective inside the step; a moe model's expert
    gather is one NCCL all-gather a layer, captured in the graph, so
    every rank captures and replays in step (they run one scheduler).
    The session's gather and the capture's eager warm-up steps use the
    communicators before the capture starts.  A capture or a replay that
    fails raises; nothing falls back to the eager step."""

    def __init__(self, serve: ShardedServe, pool=None):
        why = capture_refusal(serve.mesh)
        if why is not None:
            raise ValueError(f"ShardedCapturedStep: {why}; such a rank "
                             f"steps eagerly (ShardedServe.decode_fn)")
        super().__init__(None, serve.cfg, serve.tables, pool=pool)
        self.serve = serve

    def _held(self):
        full = self.serve._full
        if full is None:
            raise RuntimeError("ShardedCapturedStep: called outside "
                               "ShardedServe.session, which gathers the "
                               "weights it reads")
        return full

    def capture(self, cache: dict, tokens: torch.Tensor) -> None:
        self.params = self._held()
        with use_mesh(self.serve.mesh):
            super().capture(cache, tokens)

    def __call__(self, cache: dict, tokens: torch.Tensor, pos):
        if self._held() is not self.params:
            self.reset()
        return super().__call__(cache, tokens, pos)


def rank_memory(device) -> int | None:
    """``torch.cuda.memory_allocated`` on the rank's card (None on the
    CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.memory_allocated(device)
    return None


__all__ = ["PlacementPolicy", "place_tables", "plan_placement_report",
           "serve_param_shardings", "serve_cache_shardings",
           "batch_placement", "gather_rows", "shard_params",
           "init_params_sharded", "tables_checksum", "ShardedServe",
           "ShardedCapturedStep", "capture_refusal",
           "TP_AXIS", "DP_AXES"]
