"""The reference's sharded serving on a 2x2 mesh of forced host devices,
for ``test_torch_sharded.py`` to hold the port's ranks against.

  XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
      PYTHONPATH=src python tests/torch_mesh_reference.py OUT_DIR

For qwen3-0.6b and deepseek-moe-16b it rebuilds the mesh suite's inputs
(the float32 smoke config, ``PRNGKey(0)`` weights, the seed-0 shared
calibration and a 4 x 8 batch), serves 3 greedy tokens through
``ShardedServe`` (gspmd, gather backend) on a mesh of ``Auto`` axes and
through the single-device program, requires the same tokens of both, and
writes ``OUT_DIR/{arch}.npz``: the parameters (``p/<dotted name>``), the
batch's tokens, the tokens a step and the last-position logits a step of
both runs.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

assert "--xla_force_host_platform_device_count" in os.environ.get(
    "XLA_FLAGS", ""), "set XLA_FLAGS before the first jax import"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.calib import model_batch  # noqa: E402
from repro.configs import get_config, smoke_config  # noqa: E402
from repro.nn import init_params  # noqa: E402
from repro.serve import build_serving_plans  # noqa: E402
from repro.serve.plans import _greedy_decode  # noqa: E402
from repro.serve.sharded import ShardedServe  # noqa: E402

ARCHS = ("qwen3-0.6b", "deepseek-moe-16b")
N_NEW = 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run(arch: str, out_dir: str) -> None:
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              dtype="float32")
    params = init_params(cfg, jax.random.PRNGKey(0))
    plans = build_serving_plans(cfg, rng.normal(size=20000) * 3)
    cfg = plans.patched_config(cfg)
    batch = {k: jnp.asarray(v) for k, v in model_batch(cfg, rng, 4, 8).items()}
    t = batch["tokens"].shape[1]
    # Auto axes: this jax's make_mesh defaults to Explicit ones, under
    # which the reference's embedding gather raises (ROADMAP queue C)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    serve = ShardedServe(cfg, mesh, plans.tables_for_model(backend="gather",
                                                           mesh=mesh))
    toks, logits = _greedy_decode(cfg, serve.place_params(params),
                                  serve.place_batch(batch), t, N_NEW,
                                  t + N_NEW, None, serve=serve)
    one_toks, one_logits = _greedy_decode(
        cfg, params, batch, t, N_NEW, t + N_NEW,
        plans.tables_for_model(backend="gather", mesh=False))
    assert toks == one_toks
    np.savez(os.path.join(out_dir, f"{arch}.npz"),
             tokens=np.asarray(batch["tokens"]),
             steps=np.asarray(toks), logits=np.stack(logits),
             logits_single=np.stack(one_logits),
             **{f"p/{k}": v for k, v in _flat(params).items()})


if __name__ == "__main__":
    for a in ARCHS:
        run(a, sys.argv[1])
    print("ok")
