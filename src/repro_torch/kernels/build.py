"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

Every ``.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface, for
``sm_90a``.  No source includes PyTorch's headers, so a build takes seconds,
not the minutes a ``torch.utils.cpp_extension`` build of the same sources
would.  Libraries land in ``build/torch_kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so a
second build in the same checkout reuses them.

Nothing here runs at import time: :func:`load` builds on first use, and a
missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction: the LUT math spells its fused multiply-adds out
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> (source stem, argtypes)
ENTRY_POINTS = {
    "rlut_lut_act_stacked": ("lut_act", [_P, _P, _LL, _I, _P, _P, _P, _P]),
    "rlut_lut_act": ("lut_act", [_P, _P, _LL, _I, _P, _P, _P, _P]),
    "rlut_fused_matmul_lut": (
        "fused_matmul_lut",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}   # process-wide: one load per library


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "repro_torch kernels: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin) — the CUDA kernels build only where the CUDA "
        "toolkit is installed")


def _lib_path(src: Path, flags: tuple) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> dict:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, all
    in parallel.  Returns ``{stem: {"path", "seconds", "log"}}``; with
    ``verbose`` the ptxas resource report (registers, shared memory,
    spills per kernel) is in ``log``."""
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = _lib_path(src, NVCC_FLAGS)
        if lib.exists() and not verbose:
            out[src.stem] = {"path": lib, "seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib, time.perf_counter())
    for stem, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"repro_torch kernels: nvcc failed on csrc/{stem}.cu "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)   # atomic: concurrent builders never see half
        out[stem] = {"path": lib, "seconds": time.perf_counter() - t0,
                     "log": log}
    return out


def load() -> dict[str, ctypes.CDLL]:
    """The bound libraries by source stem, building them first if needed."""
    if not _LIBS:
        built = build()
        libs = {stem: ctypes.CDLL(str(info["path"]))
                for stem, info in built.items()}
        for name, (stem, argtypes) in ENTRY_POINTS.items():
            fn = getattr(libs[stem], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS.update(libs)
    return _LIBS


def entry(name: str):
    """One bound C entry point (see :data:`ENTRY_POINTS`)."""
    stem, _ = ENTRY_POINTS[name]
    return getattr(load()[stem], name)
