"""3x3 VALID convolution on pre-padded NHWC input: the resblock conv.

Counterpart of ``councilx/ops/pallas_conv.py::conv3x3_valid`` (forward).
On a CUDA tensor it launches the hand-written Hopper kernel in
``councilx_torch/csrc/conv3x3.cu``; on a CPU tensor it runs the plain
version :func:`conv3x3_valid_reference`. Nothing falls back: a CUDA input
the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from councilx_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_MIN_TILE_M = 64        # the f32 kernel's rows per block (bf16: 128)


def conv3x3_valid_reference(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv2d`` on the channels_last view.

    xp (B, H+2, W+2, C) NHWC, k (3, 3, C, O) HWIO -> (B, H, W, O) in
    xp's dtype."""
    w = k.to(xp.dtype).permute(3, 2, 0, 1)            # HWIO -> OIHW
    y = F.conv2d(xp.permute(0, 3, 1, 2), w)
    return y.permute(0, 2, 3, 1).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("conv3x3")
    fn = lib.councilx_conv3x3_valid
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def conv3x3_valid(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 stride-1 conv: xp (B, H+2, W+2, C) NHWC contiguous,
    k (3, 3, C, O) HWIO -> (B, H, W, O) in xp's dtype, f32 accumulation.

    The caller pads (reflect) and adds the bias, as in the JAX package.
    ``conv3x3_valid.launches`` counts kernel launches."""
    if xp.device.type == "cpu":
        return conv3x3_valid_reference(xp, k)
    if xp.device.type != "cuda":
        raise ValueError(f"conv3x3_valid: unsupported device {xp.device}")
    if xp.dim() != 4 or k.dim() != 4:
        raise ValueError(f"conv3x3_valid: want 4-D xp and k, got "
                         f"{tuple(xp.shape)} and {tuple(k.shape)}")
    b, hp, wp, c = xp.shape
    kh, kw, kc, o = k.shape
    h, w = hp - 2, wp - 2
    if (kh, kw) != (3, 3) or kc != c:
        raise ValueError(f"conv3x3_valid: kernel {tuple(k.shape)} does not "
                         f"match input channels {c}")
    if c % 8 or o % 8:
        raise ValueError(f"conv3x3_valid: C={c} and O={o} must be "
                         f"multiples of 8")
    if h < 1 or w < 1 or b < 1:
        raise ValueError(f"conv3x3_valid: empty output for {tuple(xp.shape)}")
    if xp.dtype not in _DTYPE_CODES:
        raise ValueError(f"conv3x3_valid: unsupported dtype {xp.dtype}")
    if -(-b * h * w // _MIN_TILE_M) > _MAX_GRID_Y:
        raise ValueError(f"conv3x3_valid: {b * h * w} output pixels exceed "
                         f"the launch grid")
    if not xp.is_contiguous():
        raise ValueError("conv3x3_valid: xp must be contiguous NHWC")
    if k.device != xp.device:
        raise ValueError(f"conv3x3_valid: k on {k.device}, xp on {xp.device}")
    k = k.to(xp.dtype).contiguous()
    if xp.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("conv3x3_valid: inputs must be 16-byte aligned")
    y = torch.empty((b, h, w, o), dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().councilx_conv3x3_valid(
            xp.data_ptr(), k.data_ptr(), y.data_ptr(), b, h, w, c, o,
            _DTYPE_CODES[xp.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_valid: kernel launch failed with CUDA "
                           f"error {err}")
    conv3x3_valid.launches += 1
    return y


conv3x3_valid.launches = 0
