"""The PyTorch port stands alone: it imports neither JAX nor the reference
package, builds no kernel at import time, and runs on the card unless the
caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               'repro_torch.')]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))
assert not bad, bad
from repro_torch.kernels import build
assert not build._LIBS, 'a kernel library was loaded at import time'
print(len(names))
"""


def test_importing_every_submodule_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 94   # every submodule was imported


_IMPORT_ONE = """
import importlib, sys
importlib.import_module({name!r})
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))
assert not bad, bad
print(int('torch' in sys.modules),
      int(any(m.startswith('repro_torch.obs') for m in sys.modules)))
"""


@pytest.mark.parametrize("name,torch_,obs_", [
    ("repro_torch.obs", 1, 1),
    ("repro_torch.launch.obs", 1, 1),
    # the engine's telemetry hook is found through sys.modules: pool
    # workers import it with numpy alone
    ("repro_torch.core.engine", 0, 0),
    # the dry run and the roofline: no telemetry, no process group at
    # import (the hill climb imports torch only when a variant runs)
    ("repro_torch.launch.dryrun", 1, 0),
    ("repro_torch.launch.hillclimb", 0, 0),
    ("repro_torch.roofline.report", 1, 0),
    # the mesh's collectives, its launcher and the captured sharded step
    ("repro_torch.nn.sharding", 1, 1),
    ("repro_torch.launch.mesh", 1, 1),
    ("repro_torch.serve.sharded", 1, 1),
    ("repro_torch.serve.batching", 1, 1),
    ("repro_torch.launch.serve", 1, 1),
    ("repro_torch.train.checkpoint", 1, 1),
])
def test_telemetry_modules_import_alone(name, torch_, obs_):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _IMPORT_ONE.format(name=name)],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(torch_), str(obs_)]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        # ml_dtypes: the card's machine has none (bf16 goes through torch)
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path,
                                                                     mod)


def _cfg():
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config("qwen3-0.6b"))


def _entry_points(tmp_path):
    from repro_torch.bench import run as bench_run
    from repro_torch.launch import lutnn, quickstart
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch import tune as tune_launcher
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serve.degrade import DegradationLadder
    from repro_torch.nn import init_params
    from repro_torch.nn.sharding import Mesh
    from repro_torch.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )
    from repro_torch.serve import (
        ContinuousBatcher,
        build_serving_plans,
        init_cache,
    )
    from repro_torch.tune import (
        load_tuned_plan,
        save_tuned_plan,
        trained_params,
        tuned_plan_from_serving,
    )

    plans = build_serving_plans(_cfg(), np.linspace(-3, 3, 4096))
    path = save_tuned_plan(str(tmp_path / "plan"),
                           tuned_plan_from_serving(_cfg(), plans))
    return {
        "init_params": lambda: init_params(_cfg()),
        "init_cache": lambda: init_cache(_cfg(), 1, 8),
        "tables_for_model": lambda: plans.tables_for_model(),
        "batcher": lambda: ContinuousBatcher(_cfg(), init_params(_cfg()),
                                             1, 8),
        "tuned_plan": lambda: load_tuned_plan(path).tables_for_model(),
        "launcher --tuned-plan": lambda: launcher.main(
            ["--tuned-plan", path]),
        "launcher": lambda: launcher.main(["--arch", "qwen3-0.6b",
                                           "--lut-act"]),
        "lutnn": lambda: lutnn.main([]),
        "quickstart": lambda: quickstart.main([]),
        "init_train_state": lambda: init_train_state(_cfg(), TrainConfig()),
        "train launcher": lambda: train_launcher.main(["--steps", "1"]),
        "tune launcher": lambda: tune_launcher.main([]),
        "trained_params": lambda: trained_params(_cfg(), train_steps=1),
        "degradation ladder": lambda: DegradationLadder(plans),
        "launcher --reload-plan": lambda: launcher.main(
            ["--arch", "qwen3-0.6b", "--lut-act", "--reload-plan", path]),
        "bench run": lambda: bench_run.main([]),
        "launcher --mesh": lambda: launcher.main(
            ["--arch", "qwen3-0.6b", "--mesh", "2,2"]),
        "mesh ranks": lambda: run_ranks(print, dp=2, tp=2),
        "train launcher --dp --tp": lambda: train_launcher.main(
            ["--steps", "1", "--dp", "2", "--tp", "2"]),
        "sharded train state": lambda: init_train_state(
            _cfg(), TrainConfig(), mesh=Mesh(("data", "model"), (1, 2),
                                             rank=0)),
        "sharded train step": lambda: make_train_step(
            _cfg(), TrainConfig(), mesh=Mesh(("data", "model"), (1, 2),
                                             rank=0)),
    }


def test_dry_run_entry_points_allocate_nothing(tmp_path):
    """The dry run's entry points run without a card by design: the
    card's program is traced on the meta device (no data, no kernel
    launched, no process group left behind)."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import SHAPES, dryrun_cell
    from repro_torch.launch.hillclimb import run_variant
    from repro_torch.serve import abstract_cache
    from repro_torch.train import (
        TrainConfig,
        abstract_batch,
        abstract_train_state,
    )

    state = abstract_train_state(_cfg(), TrainConfig())
    leaves = list(state["params"].parameters()) + state["opt"]["mu"]
    assert {t.device.type for t in leaves} == {"meta"}
    assert {t.device.type for t in abstract_batch(_cfg(), 2, 8).values()
            } == {"meta"}
    assert abstract_cache(_cfg(), 1, 8)["k"].device.type == "meta"
    info = dict(SHAPES["decode_32k"], seq=16, batch=2)
    cell = dryrun_cell("qwen3-0.6b", "decode_32k", False, quiet=True,
                       cfg=_cfg(), info=info, mesh_shape=(1, 2))
    assert cell["status"] == "ok" and not dist.is_initialized()
    res = run_variant("qwen3-0.6b", "decode_32k", "v", cfg=_cfg(),
                      info=info, mesh_shape=(1, 2), out_dir=str(tmp_path))
    assert res["status"] == "ok"


@pytest.mark.parametrize("name", ["init_params", "init_cache",
                                  "tables_for_model", "batcher",
                                  "tuned_plan", "launcher",
                                  "launcher --tuned-plan", "lutnn",
                                  "quickstart", "init_train_state",
                                  "train launcher", "tune launcher",
                                  "trained_params", "degradation ladder",
                                  "launcher --reload-plan", "bench run",
                                  "launcher --mesh", "mesh ranks",
                                  "train launcher --dp --tp",
                                  "sharded train state",
                                  "sharded train step"])
def test_entry_point_without_device_needs_the_card(name, tmp_path):
    """Called without ``device`` on a machine with no CUDA, an entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises((RuntimeError, SystemExit)) as info:
        _entry_points(tmp_path)[name]()
    if info.type is SystemExit:
        assert info.value.code == 2


def test_cuda_backend_on_a_cpu_tensor_raises():
    from repro_torch.nn.mlp import apply_lut_act
    from repro_torch.serve import build_serving_plans

    plans = build_serving_plans(_cfg(), np.linspace(-3, 3, 4096))
    tables = plans.tables_for_model(backend="cuda", device="cpu")
    tab = tables["sites"]["mlp"]
    with pytest.raises(ValueError, match="card"):
        apply_lut_act(torch.zeros(4), tab, "cuda")


def test_non_dense_families_are_not_ported_yet():
    """Nothing is left unported: every architecture of the reference is
    served, with the reference's config, and an unknown one raises
    ``KeyError``."""
    import dataclasses

    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    assert not hasattr(tconfigs, "NOT_PORTED")
    for name in jconfigs.ARCH_NAMES:
        cfg = tconfigs.get_config(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jconfigs.get_config(name))
        assert cfg.family in tconfigs.PORTED_FAMILIES
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def test_missing_cuda_toolkit_raises(monkeypatch):
    """Without nvcc the kernel build raises; nothing falls back to the
    plain versions behind the caller's back."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
