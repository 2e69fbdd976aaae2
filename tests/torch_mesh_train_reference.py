"""The reference's sharded training on meshes of forced host devices, for
``test_torch_train_sharded.py`` to hold the port's ranks against.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/torch_mesh_train_reference.py OUT_DIR

The meshes have ``Auto`` axes (this jax's ``make_mesh`` defaults to
``Explicit`` ones, under which the reference's train step raises: ROADMAP
queue C).  It writes to ``OUT_DIR``:

* ``specs.json``: ``train_state_shardings``' partition specs on a 2x2
  mesh (``grad_compress``, so ``ef_error`` too) for qwen3-0.6b,
  deepseek-moe-16b, rwkv6-3b and phi-3-vision-4.2b, by leaf path;
* ``{arch}.npz`` for qwen3-0.6b, rwkv6-3b and deepseek-moe-16b (float32
  smoke configs, ``PRNGKey(0)`` weights): the initial parameters
  (``p/<dotted name>``) and, for each mesh ``DxT`` of 2x1, 1x2 and 2x2,
  two jitted steps of ``TrainConfig(remat=False)`` on ``TokenStream``
  batches of 4 x 16: the losses and gradient norms
  (``DxT/loss``, ``DxT/grad_norm``) and the parameters after
  (``DxT/p/<name>``);
* ``compress.npz``: qwen3-0.6b on 2x2 with ``grad_compress`` for 4 steps
  (losses, norms), the parameters and the error buffers after 2 steps,
  each error leaf also as every data shard's own buffer (``e/<name>/d<i>``,
  device ``(i, 0)``'s), and the same 4 steps without compression;
* ``dp_mean.npz``: ``compressed_dp_mean`` on the 2x2 mesh over the data
  axis with a different gradient and error on each data shard (a
  replicated array whose device buffers differ, as inside the step's
  ``shard_map``): the inputs, every shard's int8 codes (int32 sums are
  theirs summed), the mean and every shard's new error;
* ``ckpt/``: the 2-step 2x2 qwen3-0.6b state saved at step 2.

With ``partitioned`` after ``OUT_DIR`` it writes only what
``test_torch_train_partitioned.py`` reads: ``part_{arch}.npz`` for the
smoke configs of qwen3-0.6b (dense, gated ``w_in``), nemotron-4-15b
(dense, relu2, no gate), deepseek-moe-16b (routed and shared experts),
phi-3-vision-4.2b (the patch prefix; its batches carry seeded float32
``patches`` of ``input_batch_specs``' shape, stored as ``patches/<step>``
for the port to read), rwkv6-3b, recurrentgemma-9b (the recurrent block,
one KV head) and whisper-small (the encoder and the cross-attention; its
batches carry seeded float32 ``frames``, stored as ``frames/<step>``),
the initial parameters and, on 1x2 and 2x2, two steps without
(``DxT/...``) and with ``grad_compress`` (``c/DxT/...``): the losses,
norms and parameters after; and ``part_whisper-small-odd.npz``,
whisper-small's smoke config with an odd vocabulary of 257 (the
published 51865 is odd too, so ``embed`` and ``lm_head`` stay whole), on
1x2 without compression.  The reference's train step is partitioned
there: ``param_specs`` place the weights over ``"tp"`` and XLA's GSPMD
divides each product by the model axis.  Under this jax its compressed
step raises on qwen3-0.6b at 1x2 (an XLA ``RET_CHECK``: a cross-partition
all-reduce outside manual partitioning) and on nemotron-4-15b (a context
mesh that does not match the sharding's); such a case records its error
(``c/DxT/error``) instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

assert "--xla_force_host_platform_device_count" in os.environ.get(
    "XLA_FLAGS", ""), "set XLA_FLAGS before the first jax import"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config, smoke_config  # noqa: E402
from repro.data import TokenStream  # noqa: E402
from repro.train import (  # noqa: E402
    TrainConfig,
    init_train_state,
    make_train_step,
    save_checkpoint,
    train_state_shardings,
)
from repro.train.compression import (  # noqa: E402
    compressed_dp_mean,
    ef_compress_grads,
)

STEP_ARCHS = ("qwen3-0.6b", "rwkv6-3b", "deepseek-moe-16b")
SPEC_ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "rwkv6-3b",
              "phi-3-vision-4.2b")
SHAPES = ((2, 1), (1, 2), (2, 2))
BATCH, SEQ = 4, 16


def mesh_of(dp: int, tp: int):
    return jax.make_mesh((dp, tp), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:dp * tp])


# a smoke config with an override, under its own name
VARIANTS = {"whisper-small-odd": ("whisper-small", {"vocab_size": 257})}


def cfg_of(arch: str):
    arch, over = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(smoke_config(get_config(arch)),
                               dtype="float32", **over)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def patches_at(cfg, i):
    """vlm's float32 patches for step ``i``: ``input_batch_specs``' shape,
    from a numpy seed (None for another family)."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(1000 + i).normal(
        size=(BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)


def frames_at(cfg, i):
    """encdec's float32 audio frames for step ``i``, as :func:`patches_at`
    (None for another family)."""
    if cfg.family != "encdec":
        return None
    return np.random.default_rng(2000 + i).normal(
        size=(BATCH, cfg.n_frames, cfg.d_model)).astype(np.float32)


def batch_at(cfg, i):
    stream = TokenStream(cfg.vocab_size, SEQ, BATCH, seed=0)
    b = stream.batch_at(i)
    if cfg.family == "vlm":
        b["patches"] = patches_at(cfg, i)
    if cfg.family == "encdec":
        b["frames"] = frames_at(cfg, i)
    return {k: jnp.asarray(v) for k, v in b.items()}


def steps(cfg, tcfg, mesh, n, at=2, keep=None):
    """``n`` jitted steps from the ``PRNGKey(0)`` state: (losses, norms);
    ``keep(state)`` sees the state after ``at`` steps (before the next
    step donates it)."""
    _, jit_step, state_sh = make_train_step(cfg, tcfg, mesh)
    state = jax.device_put(init_train_state(cfg, tcfg), state_sh)
    losses, norms = [], []
    for i in range(n):
        b = batch_at(cfg, i)
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in b.items()}
        state, m = jit_step(specs)(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i + 1 == at and keep is not None:
            keep(state)
    return losses, norms


def spec_of(s) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]


def write_specs(out_dir):
    mesh = mesh_of(2, 2)
    out = {}
    for arch in SPEC_ARCHS:
        sh = train_state_shardings(cfg_of(arch),
                                   TrainConfig(grad_compress=True), mesh)
        out[arch] = {k: spec_of(v) for k, v in flat(sh).items()}
    with open(os.path.join(out_dir, "specs.json"), "w") as f:
        json.dump(out, f)


def write_steps(out_dir):
    for arch in STEP_ARCHS:
        cfg = cfg_of(arch)
        tcfg = TrainConfig(remat=False)
        rec = {f"p/{k}": np.asarray(v) for k, v in flat(
            init_train_state(cfg, tcfg)["params"]).items()}
        for dp, tp in SHAPES:
            key = f"{dp}x{tp}"

            def keep(st, key=key):
                rec.update({f"{key}/p/{k}": np.asarray(v)
                            for k, v in flat(st["params"]).items()})
                if arch == "qwen3-0.6b" and key == "2x2":
                    save_checkpoint(os.path.join(out_dir, "ckpt"), st, 2)

            losses, norms = steps(cfg, tcfg, mesh_of(dp, tp), 2, keep=keep)
            rec[f"{key}/loss"] = np.array(losses)
            rec[f"{key}/grad_norm"] = np.array(norms)
        np.savez(os.path.join(out_dir, f"{arch}.npz"), **rec)


def write_compress(out_dir):
    cfg = cfg_of("qwen3-0.6b")
    mesh = mesh_of(2, 2)
    rec = {}
    devs = list(mesh.devices.flat)

    def keep(st):
        rec.update({f"p/{k}": np.asarray(v)
                    for k, v in flat(st["params"]).items()})
        for k, v in flat(st["ef_error"]).items():
            rec[f"e/{k}"] = np.asarray(v)
            for shard in v.addressable_shards:
                d, t = divmod(devs.index(shard.device), 2)
                if t == 0 and all(s == slice(None) for s in shard.index):
                    rec[f"e/{k}/d{d}"] = np.asarray(shard.data)

    for key, compress in (("c", True), ("u", False)):
        losses, norms = steps(
            cfg, TrainConfig(remat=False, grad_compress=compress), mesh, 4,
            keep=keep if compress else None)
        rec[f"{key}/loss"] = np.array(losses)
        rec[f"{key}/grad_norm"] = np.array(norms)
    np.savez(os.path.join(out_dir, "compress.npz"), **rec)


def write_dp_mean(out_dir):
    """The reference's own ``compressed_dp_mean``, each data shard with
    its own inputs: a replicated array is assembled from per-device
    buffers that differ by data coordinate."""
    mesh = mesh_of(2, 2)
    rng = np.random.default_rng(5)
    shapes = ((7, 5), (13,), (2, 3, 4))
    gs = [[rng.normal(size=s).astype(np.float32) * 10 ** -e
           for s, e in zip(shapes, (0, 3, 6))] for _ in range(2)]
    es = [[rng.normal(size=s).astype(np.float32) * 1e-3 for s in shapes]
          for _ in range(2)]
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    devs = list(mesh.devices.flat)

    def per_data(arrs):
        return jax.make_array_from_single_device_arrays(
            arrs[0].shape, sharding,
            [jax.device_put(arrs[i // 2], devs[i]) for i in range(4)])

    g_in = [per_data([gs[0][j], gs[1][j]]) for j in range(len(shapes))]
    e_in = [per_data([es[0][j], es[1][j]]) for j in range(len(shapes))]
    mean, new_e = compressed_dp_mean(g_in, e_in, mesh, ("data",))
    rec = {}
    for j in range(len(shapes)):
        for d in range(2):
            rec[f"g{j}/d{d}"], rec[f"e{j}/d{d}"] = gs[d][j], es[d][j]
            q8, _, _ = ef_compress_grads([jnp.asarray(gs[d][j])],
                                         [jnp.asarray(es[d][j])])
            rec[f"q{j}/d{d}"] = np.asarray(q8[0])
            buf = [s for s in new_e[j].addressable_shards
                   if s.device == devs[2 * d]][0]
            rec[f"new_e{j}/d{d}"] = np.asarray(buf.data)
        rec[f"mean{j}"] = np.asarray(mean[j])
    np.savez(os.path.join(out_dir, "dp_mean.npz"), **rec)


PART_ARCHS = ("qwen3-0.6b", "nemotron-4-15b", "deepseek-moe-16b",
              "phi-3-vision-4.2b", "rwkv6-3b", "recurrentgemma-9b",
              "whisper-small", "whisper-small-odd")
PART_SHAPES = ((1, 2), (2, 2))
# the cases a variant runs (default: both shapes, plain and compressed)
PART_ONLY = {"whisper-small-odd": (((1, 2),), (("", False),))}


def write_partitioned(out_dir):
    for arch in PART_ARCHS:
        cfg = cfg_of(arch)
        rec = {f"p/{k}": np.asarray(v) for k, v in flat(
            init_train_state(cfg, TrainConfig(remat=False))["params"]
        ).items()}
        if cfg.family == "vlm":
            rec.update({f"patches/{i}": patches_at(cfg, i) for i in (0, 1)})
        if cfg.family == "encdec":
            rec.update({f"frames/{i}": frames_at(cfg, i) for i in (0, 1)})
        shapes, modes = PART_ONLY.get(
            arch, (PART_SHAPES, (("", False), ("c/", True))))
        for dp, tp in shapes:
            for pre, compress in modes:
                key = f"{pre}{dp}x{tp}"

                def keep(st, key=key):
                    rec.update({f"{key}/p/{k}": np.asarray(v)
                                for k, v in flat(st["params"]).items()})

                try:
                    losses, norms = steps(
                        cfg, TrainConfig(remat=False, grad_compress=compress),
                        mesh_of(dp, tp), 2, keep=keep)
                except Exception as e:  # noqa: BLE001 — recorded
                    if not compress:
                        raise
                    rec[f"{key}/error"] = np.array(
                        f"{type(e).__name__}: {e}"[:300])
                    continue
                rec[f"{key}/loss"] = np.array(losses)
                rec[f"{key}/grad_norm"] = np.array(norms)
        np.savez(os.path.join(out_dir, f"part_{arch}.npz"), **rec)


if __name__ == "__main__":
    out = sys.argv[1]
    if sys.argv[2:] == ["partitioned"]:
        write_partitioned(out)
        print("ok")
        sys.exit(0)
    write_specs(out)
    write_dp_mean(out)
    write_steps(out)
    write_compress(out)
    print("ok")
