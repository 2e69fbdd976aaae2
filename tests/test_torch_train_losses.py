"""The port's training losses and their gradients against the reference,
on the CPU: ``repro_torch.nn.transformer.loss_fn`` differentiated by
autograd against ``jax.value_and_grad(repro.nn.transformer.loss_fn)``
(no mesh), for the six families' float32 smoke configs with the same
parameters (moved over by the bridge) and the same numpy-seeded batch:
qwen3-0.6b (dense), deepseek-moe-16b (moe, the router's auxiliary loss
included), phi-3-vision-4.2b (vlm, with patch embeddings), rwkv6-3b (ssm,
its WKV through the plain K8 and K8b), recurrentgemma-9b (hybrid) and
whisper-small (encdec, with audio frames).

Tolerances: the loss within ``1e-5`` relative; every gradient leaf within
``1e-4 * max|g_ref| + 1e-7`` (float32 sums in other orders, over every
layer of the backward).  ``remat`` (activation checkpointing) gives the
port's own loss and gradients bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.nn import init_params as j_init
from repro.nn.transformer import loss_fn as j_loss_fn
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.nn import init_params
from repro_torch.nn.transformer import (
    LOSS_FNS,
    decoder_forward,
    feed_forward,
    feed_forward_aux,
    loss_fn,
)
from repro_torch.train.step import batch_to_device

ARCHS = ["qwen3-0.6b", "deepseek-moe-16b", "phi-3-vision-4.2b", "rwkv6-3b",
         "recurrentgemma-9b", "whisper-small"]
B, T = 2, 16


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    cj = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config(arch)), dtype="float32")
    ct = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config(arch)), dtype="float32")
    pj = j_init(cj, jax.random.PRNGKey(0))
    batch = _batch(cj)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(cj)(p, batch=b)))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    pt = params_from_jax(jax.tree.map(np.asarray, pj), ct,
                         device="cpu").requires_grad_(True)
    return arch, ct, pt, batch, float(loss_j), _flat(g_j)


def _port_grads(ct, pt, batch, remat):
    loss = loss_fn(ct)(pt, batch=batch_to_device(batch, "cpu"), remat=remat)
    names = [n for n, _ in pt.named_parameters()]
    grads = torch.autograd.grad(loss, list(pt.parameters()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_reference(setup, remat):
    arch, ct, pt, batch, loss_j, g_j = setup
    loss, grads = _port_grads(ct, pt, batch, remat)
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j), (arch, loss,
                                                            loss_j)
    assert set(grads) == set(g_j)
    for name, g in grads.items():
        ref = g_j[name]
        tol = 1e-4 * float(np.abs(ref).max()) + 1e-7
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= tol, (arch, name, err, tol)


def test_remat_is_bit_identical(setup):
    """Recomputing each layer in the backward changes no bit of the loss
    or of any gradient."""
    _, ct, pt, batch, _, _ = setup
    loss0, g0 = _port_grads(ct, pt, batch, False)
    loss1, g1 = _port_grads(ct, pt, batch, True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_loss_fns_cover_the_families():
    from repro.nn.transformer import LOSS_FNS as J_LOSS_FNS

    assert sorted(LOSS_FNS) == sorted(J_LOSS_FNS)
    assert {f: fn.__name__ for f, fn in LOSS_FNS.items()} == {
        f: fn.__name__ for f, fn in J_LOSS_FNS.items()}


def test_moe_aux_reaches_the_loss_and_serving_is_unchanged():
    """The moe loss adds ``router_aux_weight * aux / n_layers`` (without it
    the loss is the plain cross-entropy, which differs); serving's
    ``feed_forward`` keeps returning the output alone."""
    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("deepseek-moe-16b")),
        dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    batch = batch_to_device(_batch(cfg), "cpu")
    with_aux = loss_fn(cfg)(params, batch=batch)
    no_aux = loss_fn(dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router_aux_weight=0.0)))(
        params, batch=batch)
    assert float(with_aux) > float(no_aux)
    x = torch.randn(B, T, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = feed_forward_aux(params.layer(0), x, cfg, None, layer=0)
    assert torch.equal(feed_forward(params.layer(0), x, cfg, None, layer=0),
                       y)
    assert aux.dtype == torch.float32 and aux.dim() == 0


def test_unstacked_views_give_the_stacked_gradient():
    """Through one ``unbind`` per stack the gradient of a stacked
    parameter comes back whole and equals the per-layer indexing's."""
    cfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("qwen3-0.6b")),
        dtype="float32")
    params = init_params(cfg, 0, device="cpu").requires_grad_(True)
    tokens = batch_to_device(_batch(cfg), "cpu")["tokens"]
    x, _ = decoder_forward(params, cfg, tokens)
    g_idx = torch.autograd.grad(x.square().sum(), params.blocks["w_in"])[0]
    with params.unstacked():
        x, _ = decoder_forward(params, cfg, tokens)
    g_unb = torch.autograd.grad(x.square().sum(), params.blocks["w_in"])[0]
    assert params._views is None
    assert torch.equal(g_idx, g_unb)
