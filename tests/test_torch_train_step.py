"""The port's train step against the reference's, on the CPU (float32
smoke configs, parameters moved over by the bridge): 3 steps plain, with
``microbatch=2``, with ``grad_compress`` and all three with ``remat``
(qwen3-0.6b), rwkv6-3b (its WKV through the plain K8 and K8b),
deepseek-moe-16b with microbatches (the router's auxiliary loss) and
phi-3-vision-4.2b with patches; and the int8 compression's functions.

The reference's step is built on a mesh this test makes: one device, axes
``("data", "model")`` of type ``Auto``.  Its own mesh helper
(``repro.launch.mesh.make_host_mesh``) builds ``Explicit`` axes under jax
0.9, and the step then raises at its first
``with_sharding_constraint``; on the ``Auto`` mesh it builds and its loss
equals ``jax.value_and_grad(loss_fn(cfg))`` without a mesh.

Tolerances, over 3 steps of AdamW (lr 1e-3): each step's loss within
``1e-5`` relative; every parameter leaf's mean absolute difference within
``1e-3 * lr`` and its largest within ``0.5 * lr`` per step.  AdamW's step
``m / sqrt(v)`` is about ``lr`` whatever the gradient's size, so the
float32 differences of a near-zero gradient (and, under
``grad_compress``, an int8 rounding that falls the other way) can move
single entries by a fraction of ``lr``; a wrong gradient moves entries by
up to ``2 * lr`` a step and the mean by far more.  Under ``grad_compress``
each error-feedback leaf after the 3 steps: its mean absolute difference
within ``1e-2 * max|ef_ref|`` and its largest within ``4 * max|ef_ref|``.
An int8 rounding that falls the other way moves an entry by one int8
step, about ``2 * max|ef_ref|`` on these leaves, so single entries may
differ by that much; a buffer that is not fed back, or fed back with the
wrong sign, is off by about half its typical entry everywhere, and the
mean shows it.  The compression's functions are bit for bit the
reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.data import TokenStream as JTokenStream
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.bridge import train_state_from_jax
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.compression import (
    compressed_mean_local,
    dequantize_int8,
    ef_compress_grads,
    quantize_int8,
)

LR = 1e-3
STEPS = 3


def _cfgs(arch):
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype="float32")
    return cj, ct


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batches(cfg, n):
    stream = JTokenStream(cfg.vocab_size, 16, 4, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        b = stream.batch_at(i)
        if cfg.family == "vlm":
            b["patches"] = rng.normal(
                size=(4, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


MODES = {"plain": {}, "microbatch 2": {"microbatch": 2},
         "grad_compress": {"grad_compress": True},
         "remat, microbatch 2, grad_compress": {
             "remat": True, "microbatch": 2, "grad_compress": True}}


@pytest.mark.parametrize("arch,mode",
                         [("qwen3-0.6b", m) for m in MODES]
                         + [("rwkv6-3b", "plain"),
                            ("deepseek-moe-16b", "microbatch 2"),
                            ("phi-3-vision-4.2b", "plain")])
def test_train_steps_match_reference(arch, mode):
    kw = dict(dict(remat=False), **MODES[mode])
    cj, ct = _cfgs(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    js = j_init_state(cj, jt)
    _, jit_step, _ = j_make_train_step(cj, jt, mesh)
    ts = train_state_from_jax(jax.tree.map(np.asarray, js), ct, tt,
                              device="cpu")
    tstep = make_train_step(ct, tt, device="cpu")
    for i, b in enumerate(_batches(cj, STEPS)):
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in b.items()}
        js, jm = jit_step(specs)(js, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        ts, tm = tstep(ts, b)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
            float(jm["loss"])), (i, float(tm["loss"]), float(jm["loss"]))
        assert tm["lr"] == np.float32(jm["lr"])
    assert ts["step"] == int(js["step"]) == STEPS
    assert ts["opt"]["count"] == int(js["opt"]["count"])
    ref = _flat(js["params"])
    for name, p in ts["params"].named_parameters():
        d = np.abs(p.detach().numpy() - ref[name])
        assert d.mean() <= 1e-3 * LR, (name, d.mean())
        assert d.max() <= 0.5 * LR * STEPS, (name, d.max())
    if kw.get("grad_compress"):
        eref = _flat(js["ef_error"])
        names = [n for n, _ in ts["params"].named_parameters()]
        for n, e in zip(names, ts["ef_error"]):
            assert e.shape == eref[n].shape and e.dtype == torch.float32
            top = np.abs(eref[n]).max()
            d = np.abs(e.numpy() - eref[n])
            assert d.mean() <= 1e-2 * top, (n, d.mean(), top)
            assert d.max() <= 4 * top, (n, d.max(), top)


def test_compression_is_the_references_single_shard_mean():
    """int8 quantization with the reference's scale and rounding, the
    error feedback, and the one-shard mean (``int32(q) * scale / 1``)."""
    from repro.train import compression as jc

    rng = np.random.default_rng(0)
    gs = [rng.normal(size=s).astype(np.float32) * 10 ** -e
          for s, e in (((7, 5), 0), ((13,), 3), ((2, 3, 4), 6))]
    es = [rng.normal(size=g.shape).astype(np.float32) * 1e-3 for g in gs]
    qj, sj = jc.quantize_int8(jnp.asarray(gs[0]))
    qt, st = quantize_int8(torch.from_numpy(gs[0]))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(dequantize_int8(qt, st).numpy(),
                                  np.asarray(jc.dequantize_int8(qj, sj)))
    q8j, scj, nej = jc.ef_compress_grads([jnp.asarray(g) for g in gs],
                                         [jnp.asarray(e) for e in es])
    q8t, sct, net = ef_compress_grads([torch.from_numpy(g) for g in gs],
                                      [torch.from_numpy(e) for e in es])
    for a, b in zip(q8t + sct + net, list(q8j) + list(scj) + list(nej)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mean, new_e = compressed_mean_local([torch.from_numpy(g) for g in gs],
                                        [torch.from_numpy(e) for e in es])
    for m, q, s in zip(mean, q8j, scj):
        np.testing.assert_array_equal(
            m.numpy(), np.asarray(q.astype(jnp.float32) * s / 1))
