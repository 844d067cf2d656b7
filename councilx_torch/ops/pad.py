"""The reflect and replicate pad of NHWC activations, and its backward.

Counterpart of ``councilx/nn/blocks.py::pad2d``'s ``jnp.pad`` (no Pallas
kernel: XLA fuses the pad into the reads of the op after it).
:func:`pad_nhwc` pads x (B, H, W, C) by p pixels on each side of H and W:

* on a CUDA tensor of bf16 or f32, a ``torch.autograd.Function``: its
  forward launches P1 (``csrc/pad_nhwc.cu``), a copy of whole words into
  the padded tensor, and its backward :func:`pad_fold`, which launches P1'
  (the same source): each source pixel's gradient is the sum of the padded
  positions that map onto it, in f32 in a fixed order, rounded once, with
  no atomics and no index tensor;
* on a CPU tensor, the plain version :func:`pad_reference`, the index
  gather ``x[:, ih, iw]`` (its autograd backward an ``index_put_`` with
  accumulate); :func:`pad_fold_reference` is the plain fold, written with
  slices and adds.

Nothing falls back: a CUDA input the kernels do not take raises.
``nn/blocks.py::pad2d`` sends every reflect and replicate pad here, and
counts the CUDA ones as ``pad.kernel`` (``utils/trace.py``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from councilx_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAD_CODES = {"reflect": 1, "replicate": 2}
# the kernels index rows and a row's words in int32, with room for the last
# step of a row's threads
_MAX_INDEX = 2 ** 30


def _pad_index(n: int, p: int, pad_type: str,
               device: torch.device) -> torch.Tensor:
    """Source index of each padded row (column) of :func:`pad_reference`."""
    if pad_type == "reflect" and p >= n:
        raise ValueError(f"reflect pad {p} needs a dimension > {p}, got {n}")
    idx = torch.arange(-p, n + p, device=device)
    if pad_type == "reflect":
        idx = idx.abs()
        return torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    return idx.clamp(0, n - 1)        # replicate


def pad_reference(x: torch.Tensor, p: int, pad_type: str) -> torch.Tensor:
    """Plain version of the pad: the index gather, contiguous NHWC."""
    ih = _pad_index(x.shape[1], p, pad_type, x.device)
    iw = _pad_index(x.shape[2], p, pad_type, x.device)
    return x[:, ih[:, None], iw[None, :]]


def _fold_dim(t: torch.Tensor, dim: int, n: int, p: int,
              pad_type: str) -> torch.Tensor:
    """t's padded dimension ``dim`` (n + 2p long) folded onto its n
    sources."""
    out = t.narrow(dim, p, n).clone()
    top, bottom = t.narrow(dim, 0, p), t.narrow(dim, n + p, p)
    if pad_type == "reflect":
        # padded -i -> i (1 <= i <= p); n - 1 + i -> n - 1 - i
        out.narrow(dim, 1, p).add_(top.flip(dim))
        out.narrow(dim, n - 1 - p, p).add_(bottom.flip(dim))
    else:
        out.narrow(dim, 0, 1).add_(top.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(bottom.sum(dim, keepdim=True))
    return out


def pad_fold_reference(dy: torch.Tensor, h: int, w: int, p: int,
                       pad_type: str) -> torch.Tensor:
    """Plain version of the pad's backward: dy (B, h + 2p, w + 2p, C) ->
    dx (B, h, w, C) in dy's dtype, every padded position's gradient added
    onto its source, rows then columns, in f32 (f64 stays f64), rounded
    once."""
    acc = dy.to(torch.promote_types(dy.dtype, torch.float32))
    acc = _fold_dim(_fold_dim(acc, 1, h, p, pad_type), 2, w, p, pad_type)
    return acc.to(dy.dtype)


def _check(name: str, t: torch.Tensor, h: int, w: int, p: int,
           pad_type: str):
    """The kernels' gate: a 4-D bf16 or f32 tensor, a reflect or replicate
    pad p >= 1 of an unpadded (h, w) (reflect: p below both), non-empty,
    within the kernels' int32 indexing."""
    if t.dim() != 4:
        raise ValueError(f"{name}: want NHWC, got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")
    if pad_type not in _PAD_CODES:
        raise ValueError(f"{name}: unknown pad_type {pad_type}")
    if not isinstance(p, int) or p < 1:
        raise ValueError(f"{name}: padding must be an int >= 1, got {p}")
    if t.numel() == 0:
        raise ValueError(f"{name}: empty input {tuple(t.shape)}")
    if pad_type == "reflect" and p >= min(h, w):
        raise ValueError(f"reflect pad {p} needs a dimension > {p}, got "
                         f"{min(h, w)}")
    b, c = t.shape[0], t.shape[3]
    if b * (h + 2 * p) > _MAX_INDEX or (w + 2 * p) * c > _MAX_INDEX:
        raise ValueError(f"{name}: {tuple(t.shape)} padded by {p} exceeds "
                         f"the kernel's int32 indexing")


def _word_bytes(*tensors: torch.Tensor) -> int:
    """Bytes the kernels move at once: the largest of 16, 8, 4 and 2 (not
    below one element) that divides a pixel's C x element size, every
    tensor's address and its batch, row and column strides; above one
    element only where the channels are contiguous."""
    esize = tensors[0].element_size()
    c = tensors[0].shape[3]
    for word in (16, 8, 4):
        if word > esize and (c * esize) % word == 0 and all(
                t.data_ptr() % word == 0 and t.stride(3) == 1
                and all((t.stride(d) * esize) % word == 0
                        for d in range(3) if t.shape[d] > 1)
                for t in tensors):
            return word
    return esize


def _strides(t: torch.Tensor, word: int) -> list:
    """t's batch, row and column strides in words (0 for a dimension of
    one), and its channel stride in elements."""
    per = word // t.element_size()
    return [t.stride(d) // per if t.shape[d] > 1 else 0
            for d in range(3)] + [t.stride(3)]


def _pad_lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("pad_nhwc")
    fwd, fold = lib.councilx_pad_nhwc, lib.councilx_pad_nhwc_fold
    if fwd.argtypes is None:
        tail = ([ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                + [ctypes.c_int] * 2)
        fwd.argtypes = [ctypes.c_void_p] * 2 + tail + [ctypes.c_int,
                                                       ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        fold.argtypes = [ctypes.c_void_p] * 2 + tail + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fold.restype = ctypes.c_int
    return lib


def _pad_cuda(x: torch.Tensor, p: int, pad_type: str) -> torch.Tensor:
    """P1's launch: x -> the padded contiguous NHWC tensor."""
    if x.dim() != 4:
        raise ValueError(f"pad_nhwc: want NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _check("pad_nhwc", x, h, w, p, pad_type)
    y = torch.empty((b, h + 2 * p, w + 2 * p, c), dtype=x.dtype,
                    device=x.device)
    word = _word_bytes(x, y)
    with torch.cuda.device(x.device):
        err = _pad_lib().councilx_pad_nhwc(
            x.data_ptr(), y.data_ptr(), b, h, w,
            c * x.element_size() // word, *_strides(x, word), p,
            _PAD_CODES[pad_type], word,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pad_nhwc: launch failed with CUDA error {err}")
    pad_nhwc.launches += 1
    return y


def pad_fold(dy: torch.Tensor, h: int, w: int, p: int,
             pad_type: str) -> torch.Tensor:
    """Backward of :func:`pad_nhwc` for an unpadded (h, w): dy (B, h + 2p,
    w + 2p, C), any strides -> dx (B, h, w, C) contiguous, in dy's dtype.

    On a CUDA tensor P1' (``csrc/pad_nhwc.cu``), one launch that reads
    each element of dy once, bit-deterministic; ``pad_fold.launches``
    counts its launches. Elsewhere :func:`pad_fold_reference`."""
    if dy.device.type != "cuda":
        return pad_fold_reference(dy, h, w, p, pad_type)
    return _fold_cuda(dy, h, w, p, pad_type)


def _fold_cuda(dy: torch.Tensor, h: int, w: int, p: int,
               pad_type: str) -> torch.Tensor:
    """P1''s launch (see :func:`pad_fold`)."""
    _check("pad_fold", dy, h, w, p, pad_type)
    b, hp, wp, c = dy.shape
    if (hp, wp) != (h + 2 * p, w + 2 * p):
        raise ValueError(f"pad_fold: dy {tuple(dy.shape)} is not ({h}, {w}) "
                         f"padded by {p}")
    dx = torch.empty((b, h, w, c), dtype=dy.dtype, device=dy.device)
    word = _word_bytes(dy, dx)
    with torch.cuda.device(dy.device):
        err = _pad_lib().councilx_pad_nhwc_fold(
            dy.data_ptr(), dx.data_ptr(), b, h, w,
            c * dy.element_size() // word, *_strides(dy, word), p,
            _PAD_CODES[pad_type], _DTYPE_CODES[dy.dtype], word,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pad_fold: launch failed with CUDA error {err}")
    pad_fold.launches += 1
    return dx


class _Pad(torch.autograd.Function):
    """P1 forward, P1' backward."""

    @staticmethod
    def forward(ctx, x, p: int, pad_type: str):
        ctx.fold = (x.shape[1], x.shape[2], p, pad_type)
        return _pad_cuda(x, p, pad_type)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        return pad_fold(dy, *ctx.fold), None, None


def pad_nhwc(x: torch.Tensor, p: int, pad_type: str) -> torch.Tensor:
    """x (B, H, W, C), any strides, padded by p on each side of H and W,
    as torch's ReflectionPad2d / ReplicationPad2d do it ('reflect',
    'replicate'): contiguous NHWC, differentiable on every device.

    ``pad_nhwc.launches`` counts P1's launches."""
    if x.device.type != "cuda":
        return pad_reference(x, p, pad_type)
    return _Pad.apply(x, p, pad_type)


pad_nhwc.launches = 0
pad_fold.launches = 0
