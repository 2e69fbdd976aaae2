"""The train step (the reference's ``train/step.py``), on one device or
as one rank of a mesh.

:func:`make_train_step` returns ``step(state, batch) -> (state,
metrics)``: the family's loss (:func:`repro_torch.nn.transformer.loss_fn`)
and its gradients by autograd, ``remat`` as activation checkpointing per
layer, microbatches as a Python loop that sums the gradients in float32
and divides by ``microbatch`` (the reference's ``lax.scan`` with float32
accumulators), the int8 error-feedback compression under
``grad_compress``, and :func:`repro_torch.optim.adamw_update` in place
with the global norm of step 5 below (a moe expert stack's term the sum
of its ``(layer, expert)`` slabs' square sums).  The metrics are the
reference's: ``loss``, ``grad_norm`` (0-d tensors, no host read) and
``lr`` (float32).

With a ``mesh`` the step is an explicit SPMD program in the exact mode of
sharded serving (:mod:`repro_torch.serve.sharded`): a rank's state is its
shares (:func:`~repro_torch.train.state.train_state_shardings`), and each
step

1. gathers the parameters into full tensors (the moe expert stacks stay
   split over the model axis: :mod:`repro_torch.nn.moe`);
2. takes the rank's rows of the global batch (:func:`batch_shardings`,
   dim 0 over the data axes, as the reference's jit shards one batch);
3. runs the forward and autograd at single-device shapes (microbatches
   within the rank's rows);
4. casts the gradients to float32 and sums them over the data axes in
   rank order, ``0 + g_0 + g_1 + ...``, then divides by ``n_dp`` (one
   member's gradient at a time into one accumulator:
   :func:`~repro_torch.nn.sharding.each_member`); the loss is averaged
   the same way.  An expert stack's gradient stays the rank's share over
   the model axis: no rank holds a whole one, as no device of the
   reference does (its ``shard_map`` is manual over the data axes only);
5. takes the global norm leaf by leaf: a full mean gradient's square sum,
   and for an expert stack the ``(L, E)`` square sums of its ``(layer,
   expert)`` slabs, the rank's own experts' from its share, gathered
   over the model axis into expert order (a few KB) and summed as the
   single-device step sums the whole stack's;
6. runs AdamW on the rank's own shares with that norm (its piece of a
   full mean gradient, or of an expert stack's share).

So at ``microbatch=None`` a sharded step on any ``(dp, tp)`` is bit for
bit the single-device step with ``microbatch=dp`` (the same float32 sums
in the same order), and at dp 1 the single-device step itself.  Under
``grad_compress`` each rank compresses its own gradients against the
error buffers gathered over the data axes (an expert stack's share
against its share of them, its scale the whole leaf's: the shares'
``max|x|`` maxed over the model axis) and the ranks meet in
:func:`~repro_torch.train.compression.compressed_dp_mean`; a rank keeps
its share of its own new error buffer, which is what the reference's
``ef_error`` holds after its step (its per-shard buffers leave the
``shard_map`` under a replicated spec, and the step's output placement
keeps each device's slice of its own).  The step's gathers take one
all-gather a leaf where the backend has one (NCCL with a card a rank;
:func:`~repro_torch.nn.sharding.gather_route`), and the rank-order sums
stay one broadcast a member.  Checkpoints (:mod:`.checkpoint`) gather
whole leaves on rank 0, outside the step.  The sharded step runs
eagerly, as the single-device training step does (no training step is
captured in a CUDA graph); ``step.timings`` holds the last call's
seconds (host clock, the device synchronized) of the weight gather, the
forward and backward, the gradient reduction and the update.

With ``tp_mode="partitioned"`` (the dense family) the step is the
reference's GSPMD train step instead: its ``param_specs`` placements kept
in the compute over the model axis.  The state and its placements are
exact mode's (so checkpoints and the elastic re-mesh are the same), and
each step

1. gathers each leaf over the data axes only (the reference's ZeRO-3
   ``"fsdp"`` axis), keeping the model axis's split of the leaves
   :func:`~repro_torch.nn.transformer.dense_tp_shares` names (the
   column-parallel ``wq`` / ``wk`` / ``wv`` / ``w_in``, the row-parallel
   ``wo`` / ``w_out``, the vocab-split ``embed`` and ``lm_head``); a
   gated ``w_in`` share is exchanged within the model axis into the
   compute's ``[gate_i | up_i]`` (one all-to-all of one share's bytes,
   :func:`~repro_torch.nn.sharding.gate_up_exchange`);
2. runs the rank's rows through the model on those shares
   (:func:`~repro_torch.nn.sharding.use_tp`: the activations' partial
   sums and gradients all-reduced over the model axis, a vocab-parallel
   embedding and cross-entropy), its gated ``w_in`` gradient exchanged
   back to the stored layout;
3. takes the rank-order mean over the data axes, as exact mode does
   (under ``grad_compress`` a split leaf's share against its share of
   the error buffers, its scale the whole leaf's);
4. forms the global norm from the split leaves' share square sums summed
   over the model axis, each replicated leaf counted once;
5. runs AdamW on the rank's own shares.

No rank holds a whole split leaf or its gradient.  ``tp_mode="exact"``
stays the default, every bit as before.

Serving's counterparts of the reference's ``make_serve_step`` and
``make_prefill`` are :func:`repro_torch.serve.decode_step` (captured in a
CUDA graph by :class:`repro_torch.serve.CapturedStep`) and
:func:`repro_torch.serve.prefill`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import lm_batch_specs
from repro_torch.device import resolve_device, synchronize
from repro_torch.nn.sharding import (
    DP_AXES,
    TP_AXIS,
    Placement,
    all_reduce,
    each_member,
    gate_up_exchange,
    named_sharding,
    use_mesh,
    use_tp,
)
from repro_torch.nn.transformer import dense_tp_shares, loss_fn, params_class
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import slab_square_sums, square_sum

from .compression import compressed_dp_mean, compressed_mean_local
from .state import TrainConfig, train_state_shardings

# the moe expert stacks, (L, E, ., .): split over the model axis through
# the compute, each (layer, expert) slab its own term of the norm
_EXPERT_PARAMS = ("moe_w_in", "moe_w_out")

TP_MODES = ("exact", "partitioned")


def _is_expert(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in _EXPERT_PARAMS


def _norm_term(name: str, g: torch.Tensor, gather=None) -> torch.Tensor:
    """Leaf ``name``'s term of the global norm: an expert stack's slab
    terms (:func:`~repro_torch.optim.adamw.slab_square_sums`) summed as
    one ``(L, E)`` tensor, put into expert order by ``gather`` when ``g``
    is a share over the model axis; any other leaf's ``square_sum``."""
    if not _is_expert(name):
        return square_sum(g)
    sq = slab_square_sums(g)
    return torch.sum(sq if gather is None else gather(sq))


def input_batch_specs(cfg: ArchConfig, global_batch: int, seq_len: int
                      ) -> dict[str, tuple]:
    """``{name: (shape, numpy dtype)}`` of a training batch: tokens and
    labels, vlm's patch embeddings, encdec's audio frames."""
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((global_batch, cfg.n_patches, cfg.d_model),
                            np.dtype(np.float32))
    if cfg.family == "encdec":
        extra["frames"] = ((global_batch, cfg.n_frames, cfg.d_model),
                           np.dtype(np.float32))
    return lm_batch_specs(global_batch, seq_len, extra)


def abstract_batch(cfg: ArchConfig, global_batch: int, seq_len: int,
                   device="meta") -> dict:
    """A batch of :func:`input_batch_specs`' shapes without data (the
    ``meta`` device, or fake tensors inside a ``FakeTensorMode``), as
    :func:`batch_to_device` leaves it: integer leaves int64, float leaves
    float32.  The dry run's input."""
    return {name: torch.empty(shape, device=device, dtype=(
                torch.float32 if np.dtype(dt).kind == "f" else torch.long))
            for name, (shape, dt) in input_batch_specs(
                cfg, global_batch, seq_len).items()}


def batch_shardings(cfg: ArchConfig, mesh, batch_specs: dict) -> dict:
    """``{name: Placement}`` of a global batch (``{name: (shape,
    dtype)}``, :func:`input_batch_specs`): dim 0 over the data axes."""
    return {name: named_sharding(mesh, "dp", *(None,) * (len(shape) - 1),
                                 shape=shape)
            for name, (shape, _) in batch_specs.items()}


def batch_to_device(batch: dict, device) -> dict:
    """A numpy (or tensor) batch on ``device``: integer leaves as int64
    (indices), float leaves as float32."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        dt = torch.long if not t.is_floating_point() else torch.float32
        out[name] = t.to(device=device, dtype=dt)
    return out


def _split_micro(batch: dict, n_micro: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"microbatch {n_micro} does not divide the batch "
                         f"of {b}")
    m = b // n_micro
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n_micro)]


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, device=None,
                    lut_tables=None, mesh=None, tp_mode: str = "exact"):
    """``step(state, batch) -> (state, metrics)``, updating ``state`` in
    place.  ``lut_tables`` (compressed activations in the forward) must use
    the ``gather`` backend: the kernels' entries have no gradient (neither
    have the reference's Pallas entries).  ``mesh``: this rank's mesh
    (:func:`repro_torch.launch.mesh.make_host_mesh`), ``state`` its
    shares and ``batch`` the global batch (module docstring).
    ``tp_mode``: ``"exact"`` (gathered weights) or ``"partitioned"`` (the
    dense family's tp shares in the compute; without a mesh, or on a
    model axis of 1, nothing splits and it is the same step); anything
    else raises, as does ``"partitioned"`` on another family or with
    ``lut_tables``."""
    if tp_mode not in TP_MODES:
        raise ValueError(f"make_train_step: tp_mode {tp_mode!r}; expected "
                         f"one of {TP_MODES}")
    if tp_mode == "partitioned":
        if cfg.family != "dense":
            raise ValueError(f"make_train_step: tp_mode 'partitioned' "
                             f"covers the dense family, not {cfg.family!r} "
                             f"({cfg.name})")
        if lut_tables is not None:
            raise ValueError("make_train_step: tp_mode 'partitioned' takes "
                             "no LUT tables")
    dev = resolve_device(device)
    if lut_tables is not None and lut_tables.get("backend") != "gather":
        raise ValueError(
            f"make_train_step: LUT tables on the "
            f"{lut_tables.get('backend')!r} backend have no gradient; "
            f"train with backend 'gather'")
    base_loss = loss_fn(cfg)
    n_micro = tcfg.microbatch or 1

    def loss_of(params, batch):
        return base_loss(params, batch=batch, remat=tcfg.remat,
                         chunk_q=tcfg.chunk_q, lut_tables=lut_tables)

    def grads(loss, plist):
        # a parameter the loss does not reach (vlm's patch_proj without
        # patches) gets zeros, as jax.grad gives it
        return list(torch.autograd.grad(loss, plist, allow_unused=True,
                                        materialize_grads=True))

    def grads_of(params, batch):
        plist = list(params.parameters())
        if n_micro == 1:
            loss = loss_of(params, batch)
            return loss.detach(), grads(loss, plist)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in plist]
        losses = []
        for mb in _split_micro(batch, n_micro):
            loss = loss_of(params, mb)
            for a, g in zip(acc, grads(loss, plist)):
                a.add_(g.float())
            losses.append(loss.detach())
        div = torch.tensor(n_micro, dtype=torch.float32, device=dev)
        return torch.mean(torch.stack(losses)), [a / div for a in acc]

    if mesh is not None:
        return _sharded_step(cfg, tcfg, dev, mesh, grads_of, tp_mode)

    def step(state: dict, batch: dict):
        batch = batch_to_device(batch, dev)
        params = state["params"]
        loss, g = grads_of(params, batch)
        if tcfg.grad_compress:
            g, new_error = compressed_mean_local(g, state["ef_error"])
            state["ef_error"] = new_error
        gnorm = torch.sqrt(sum(_norm_term(n, gi) for (n, _), gi in zip(
            params.named_parameters(), g)))
        metrics = adamw_update(g, state["opt"], list(params.parameters()),
                               tcfg.optimizer, gnorm=gnorm)
        state["step"] += 1
        return state, {"loss": loss, **metrics}

    return step


def _sharded_step(cfg: ArchConfig, tcfg: TrainConfig, dev, mesh, grads_of,
                  tp_mode: str = "exact"):
    """The step on ``mesh`` (module docstring), around the single-device
    ``grads_of`` of the rank's rows."""
    pl = train_state_shardings(cfg, tcfg, mesh)["params"]
    dp_axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
    n_dp = 1
    for a in dp_axes:
        n_dp *= mesh.shape[a]
    tp = (dense_tp_shares(cfg, pl, mesh) if tp_mode == "partitioned"
          else None)
    split = tp.split if tp is not None else frozenset()
    gate_up = tp.gate_up if tp is not None else frozenset()
    # an expert stack split over the model axis stays split in the compute,
    # as does every leaf a partitioned step splits
    keep = {n: (TP_AXIS,) if n in split or (
        _is_expert(n) and not pl[n].only((TP_AXIS,)).replicated)
            else () for n in pl}
    # the rank's share of a leaf from what the step holds of it: the whole
    # leaf, or an expert stack's share over the model axis
    own = {n: pl[n].only(tuple(a for a in mesh.axis_names if a != TP_AXIS))
           if keep[n] else pl[n] for n in pl}
    # an expert stack's (L, E / tp) slab terms into expert order
    slabs = {n: Placement(mesh, pl[n].spec[:2]).only(keep[n])
             for n in pl if keep[n] and _is_expert(n)}
    div = torch.tensor(n_dp, dtype=torch.float32, device=dev)
    timings = {}

    def mark(key, t0):
        synchronize(dev)
        now = time.perf_counter()
        timings[key] = now - t0
        return now

    def rows(batch: dict) -> dict:
        batch = batch_to_device(batch, dev)
        for k, v in batch.items():
            if v.shape[0] % n_dp:
                raise ValueError(f"sharded train step: the global batch of "
                                 f"{v.shape[0]} does not divide over "
                                 f"{n_dp} data ranks")
        placed = batch_shardings(cfg, mesh, {k: (tuple(v.shape), v.dtype)
                                             for k, v in batch.items()})
        return {k: placed[k].local(v) for k, v in batch.items()}

    def rank_order_mean(t: torch.Tensor) -> torch.Tensor:
        """``(0 + t_0 + t_1 + ...) / n_dp`` in float32 over the data
        ranks (the single-device microbatch sum)."""
        acc = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        for m in each_member(t, mesh, dp_axes):
            acc.add_(m.float())
        return acc / div

    def leaf(n, p):
        t = pl[n].gather(p.detach(), keep=keep[n])
        return gate_up_exchange(t, mesh) if n in gate_up else t

    def norm(sqs: list, names: list) -> torch.Tensor:
        """The global norm from the leaves' terms in leaf order, a
        partitioned step's split leaves' share terms summed over the model
        axis first (one all-reduce of them all)."""
        at = [i for i, n in enumerate(names) if n in split]
        if at:
            summed = all_reduce(torch.stack([sqs[i] for i in at]), mesh,
                                TP_AXIS)
            for j, i in enumerate(at):
                sqs[i] = summed[j]
        return torch.sqrt(sum(sqs))

    def step(state: dict, batch: dict):
        t0 = time.perf_counter()
        named = list(state["params"].named_parameters())
        params = params_class(cfg)(cfg, dev, leaves={
            n: leaf(n, p) for n, p in named})
        params.requires_grad_(True)
        t0 = mark("gather_s", t0)
        with use_mesh(mesh), use_tp(tp):
            loss, g = grads_of(params, rows(batch))
        del params
        t0 = mark("forward_backward_s", t0)
        if n_dp > 1:
            loss = torch.mean(torch.stack(
                [m.clone() for m in each_member(loss, mesh, dp_axes)]))
        sqs, shares, errs = [], [], []
        for i, (n, _) in enumerate(named):
            gi, g[i] = g[i], None
            if n in gate_up:
                gi = gate_up_exchange(gi, mesh, inverse=True)
            if tcfg.grad_compress:
                # an expert stack's share against its share of the error
                # buffers, its scale the whole leaf's (max over the model
                # axis)
                (gi,), (e,) = compressed_dp_mean(
                    [gi], [pl[n].gather(state["ef_error"][i], keep=keep[n])],
                    mesh, dp_axes, keep[n])
                errs.append(own[n].local(e))
            elif n_dp > 1:
                gi = rank_order_mean(gi)
            sqs.append(_norm_term(n, gi, slabs[n].gather if n in slabs
                                  else None))
            shares.append(own[n].local(gi))
        gnorm = norm(sqs, [n for n, _ in named])
        if tcfg.grad_compress:
            state["ef_error"] = errs
        t0 = mark("reduce_s", t0)
        metrics = adamw_update(shares, state["opt"], [p for _, p in named],
                               tcfg.optimizer, gnorm=gnorm)
        state["step"] += 1
        mark("update_s", t0)
        return state, {"loss": loss, **metrics}

    step.timings = timings
    return step
