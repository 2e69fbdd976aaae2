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
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
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
    assert int(r.stdout.strip()) >= 25   # every submodule was imported


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
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _cfg():
    from repro_torch.configs import get_config, smoke_config

    return smoke_config(get_config("qwen3-0.6b"))


def _entry_points():
    from repro_torch.launch import serve as launcher
    from repro_torch.nn import init_params
    from repro_torch.serve import build_serving_plans, init_cache

    plans = build_serving_plans(_cfg(), np.linspace(-3, 3, 4096))
    return {
        "init_params": lambda: init_params(_cfg()),
        "init_cache": lambda: init_cache(_cfg(), 1, 8),
        "tables_for_model": lambda: plans.tables_for_model(),
        "launcher": lambda: launcher.main(["--lut-act"]),
    }


@pytest.mark.parametrize("name", ["init_params", "init_cache",
                                  "tables_for_model", "launcher"])
def test_entry_point_without_device_needs_the_card(name):
    """Called without ``device`` on a machine with no CUDA, an entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is valid")
    with pytest.raises((RuntimeError, SystemExit)) as info:
        _entry_points()[name]()
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
    from repro_torch.configs import get_config

    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config("rwkv6-3b")


def test_missing_cuda_toolkit_raises(monkeypatch):
    """Without nvcc the kernel build raises; nothing falls back to the
    plain versions behind the caller's back."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
