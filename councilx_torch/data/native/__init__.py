"""ctypes binding of the native C++ image loader (``cxloader.cc``).

Counterpart of ``councilx/data/native/__init__.py``. The shared library is
built with g++ at first use into the git-ignored ``build/`` tree beside the
CUDA kernels (``build/councilx_torch_native/``, named by a hash of the
source). :func:`load_native` returns None where g++, libjpeg or libpng is
missing, and the loader then decodes with PIL in a thread pool: host
decode either way, with the same pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

from councilx_torch.ops._build import BUILD_DIR as _KERNEL_BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "cxloader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_KERNEL_BUILD_DIR),
                         "councilx_torch_native")
_lock = threading.Lock()
# (tried, library or None): the build and load are attempted once per
# process
_state = {"tried": False, "lib": None}


def _build_lib() -> Optional[str]:
    """Path of the built library, compiling it if needed; None if g++ or a
    library it links is missing."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libcxloader-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp, "-ljpeg", "-lpng", "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so_path)
    return so_path


def load_native():
    """The loaded ctypes library, or None where it cannot be built or
    loaded."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        so_path = _build_lib()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.cxl_open.restype = ctypes.c_void_p
        lib.cxl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cxl_load_batch.restype = ctypes.c_int
        lib.cxl_load_batch.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_long),
                                       ctypes.c_int, ctypes.c_void_p]
        lib.cxl_close.restype = None
        lib.cxl_close.argtypes = [ctypes.c_void_p]
        _state["lib"] = lib
        return lib


class NativeImageLoader:
    """Decode and resize a fixed list of image paths with the C++ thread
    pool, as ``dataset._load_resize_crop`` does (shorter-side
    triangle-filter resize, center crop to a ``new_size`` square, HWC
    uint8)."""

    def __init__(self, paths: Sequence[str], new_size: int,
                 threads: int = 8):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self.paths: List[str] = list(paths)
        self.new_size = new_size
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._ctx = lib.cxl_open(arr, len(self.paths), new_size, threads)
        if not self._ctx:
            raise RuntimeError("cxl_open failed")

    def load_batch(self, indices: np.ndarray) -> np.ndarray:
        """indices (B,) -> (B, new_size, new_size, 3) uint8. Raises
        IOError where a file fails to decode, so that the caller can decode
        that batch with PIL."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.paths)):
            raise IndexError(f"indices out of range for {len(self.paths)} "
                             f"images")
        out = np.empty((len(idx), self.new_size, self.new_size, 3), np.uint8)
        failures = self._lib.cxl_load_batch(
            self._ctx, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx), out.ctypes.data_as(ctypes.c_void_p))
        if failures:
            raise IOError(f"native loader failed on {failures} image(s)")
        return out

    def close(self):
        if getattr(self, "_ctx", None):
            self._lib.cxl_close(self._ctx)
            self._ctx = None

    def __del__(self):
        self.close()
