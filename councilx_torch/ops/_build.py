"""Build the port's kernels from their sources at first use.

CUDA sources (``councilx_torch/csrc/*.cu``) have a plain C interface. They
are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/councilx_torch_kernels/`` beside the package and loaded with
``ctypes``. The library's name carries a hash of the source and the flags,
so an edited source is never served by a stale build.

Triton kernels live in ``councilx_torch/csrc/*_triton.py`` and are imported
from there at first use, because ``triton`` exists only where there is a
GPU; Triton's own compile cache is kept in the same build directory.

Both happen under one lock, so the serving engine's threads cannot race a
build. There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
import time
from types import ModuleType
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "councilx_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_modules: Dict[str, ModuleType] = {}
# seconds each build or import took in this process, by source name
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and
    load it."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        build_seconds[name] = time.perf_counter() - t0
        return lib


def load_triton_module(name: str) -> ModuleType:
    """Import ``csrc/<name>.py`` (a module of ``@triton.jit`` kernels)."""
    with _lock:
        mod = _modules.get(name)
        if mod is not None:
            return mod
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(BUILD_DIR, "triton"))
        path = os.path.join(CSRC_DIR, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"councilx_torch._csrc_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[name] = mod
        build_seconds[name] = time.perf_counter() - t0
        return mod
