"""Build the port's kernels from their sources at first use.

CUDA sources (``councilx_torch/csrc/*.cu``) have a plain C interface. They
are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/councilx_torch_kernels/`` beside the package and loaded with
``ctypes``. The library's name carries a hash of the source, of every
header in ``csrc/`` (``*.cuh``, ``*.h``) and of the flags, so an edited
source or header is never served by a stale build.

The sources: ``conv3x3`` (K1/K1'), ``conv3x3_wgrad`` (K2),
``instance_norm_fwd`` (K3/K4), ``instance_norm_bwd`` (K5/K6), ``pad_nhwc``
(P1/P1', the reflect and replicate pad and its fold), and the W8A8
serving kernels ``quant_act`` (Q2) and ``conv_int8`` (Q1); each loads on
its first use, and ``chip_smoke.py`` builds them all at once.

Builds happen under one lock, so the serving engine's threads cannot race
a build; :func:`build_cuda_libraries` runs one ``nvcc`` per source at once.
There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

from councilx_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "councilx_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds each build took in this process, by source name
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


def _library_path(name: str) -> str:
    """The build of ``csrc/<name>.cu``, named by a hash of the source, the
    headers a source may include and the flags."""
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
                     + glob.glob(os.path.join(CSRC_DIR, "*.h")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _compile(names) -> int:
    """Run one ``nvcc`` per missing library, all at once; raise if any
    fails, else return how many ran. Called under the lock."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            src = os.path.join(CSRC_DIR, f"{name}.cu")
            jobs.append((src, tmp, out, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, tmp, out, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return len(jobs)


def build_cuda_libraries(names) -> None:
    """Compile and load ``csrc/<name>.cu`` for every name, the compilers
    running in parallel."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return
        with trace.span("setup.kernel_load"):
            t0 = time.perf_counter()
            trace.count("kernels_built", _compile(todo))
            for name in todo:
                _libs[name] = ctypes.CDLL(_library_path(name))
                build_seconds[name] = time.perf_counter() - t0
            trace.count("kernels_loaded", len(todo))


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and
    load it."""
    lib = _libs.get(name)
    if lib is None:
        build_cuda_libraries([name])
        lib = _libs[name]
    return lib

