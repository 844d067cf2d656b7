"""W8A8 int8 quantization of the serving convs (serving only).

Counterpart of ``councilx/ops/quant.py``:

* **weights**: per-output-channel symmetric int8, ``w_s[o] = max(max|W[...,
  o]|, 1e-12) / 127`` (:func:`quantize_kernel_per_channel`);
* **activations**: symmetric int8, either per image from the image's own
  ``max|x|`` (``quant: w8a8``, :func:`quantize_act_per_image`) or per
  tensor from a calibrated scale (``quant: w8a8_static``,
  :func:`quantize_act_static`);
* **accumulation**: exact int32, then ``acc * (a_s * w_s) + bias`` in f32,
  cast to the compute dtype (:func:`conv_w8a8`).

The plain functions above run on any device and are what the CPU runs.
The serving path takes two steps, each a hand-written Hopper kernel on a
CUDA tensor (there is no int8 convolution in PyTorch on CUDA, and the
JAX package's is XLA's, not a Pallas kernel):

* :func:`quantize_act` (Q2, ``csrc/quant_act.cu``): activation -> int8,
  writing the **padded** tensor straight from the unpadded input with
  ``pad2d``'s own reflect/replicate/zero index. A pad only copies values,
  so max|pad(x)| = max|x| and the codes equal those of pad-then-quantize,
  the JAX package's order;
* :func:`conv_int8` (Q1, ``csrc/conv_int8.cu``): the int8 implicit-GEMM
  VALID conv with the rescale and bias in its epilogue.

A weight is quantized once per value by :func:`quantize_weights`, which
lays it out for Q1 ([O][kh][kw][C], C padded to a multiple of 16 and O to a
multiple of 8 with zeros); the plain conv slices the padding off.

Exactness: the int32 sums are exact on both sides (|acc| <= 127^2 K, below
2^31 and 2^53 for every conv here), so :func:`conv_w8a8_reference` takes
them from a float64 ``F.conv2d``; the quantize divides (never multiplies by
a reciprocal), rounds half to even and clips to +-127, and the rescale
multiplies and adds without a fused multiply-add, as the JAX op does.

Nothing here has a gradient: under autograd the wrappers raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from councilx_torch.ops import _build

_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_PAD_TYPES = {"zero": 0, "reflect": 1, "replicate": 2}
_MAX_INDEX = 2 ** 31 - 1     # the kernels index rows and pixels in int32
# Q2: threads per block (csrc/quant_act.cu's THREADS), channels per item,
# and the fewest iterations a chunk of an image is given where the image
# has them (the static mode's blocks take exactly that many)
_QUANT_THREADS = 256
_QUANT_GROUP = 16
_QUANT_MIN_ITERS = 2
# Q1: the largest kernel side and stride its tensor maps take
_CONV_MAX_K = 8


class QuantWeight(NamedTuple):
    """A conv kernel quantized for Q1: ``w8`` (O', kh, kw, C') int8 with
    C' = C rounded up to 16 and O' = O rounded up to 8 (zeros beyond), and
    ``w_s`` (O',) f32 (zeros beyond O)."""
    w8: torch.Tensor
    w_s: torch.Tensor
    in_channels: int
    out_channels: int


# ---------------------------------------------------------------------------
# plain versions (the JAX package's arithmetic; any device)
# ---------------------------------------------------------------------------


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division: on CUDA, PyTorch divides by a Python
    number as a multiply by its reciprocal, which can differ in the last
    bit; a tensor divisor is divided elementwise."""
    return t / torch.tensor(127.0, dtype=t.dtype, device=t.device)


def quantize_kernel_per_channel(kernel: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kh, kw, I, O) float kernel -> (int8 kernel, f32 scale (O,))."""
    k32 = kernel.float()
    w_s = div127(k32.abs().amax(dim=(0, 1, 2)).clamp_min(1e-12))
    k8 = torch.round(k32 / w_s).clamp(-127, 127).to(torch.int8)
    return k8, w_s


def quantize_act_per_image(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, C) float -> (int8 x, f32 scale (B, 1, 1, 1))."""
    x32 = x.float()
    a_s = div127(x32.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-12))
    q = torch.round(x32 / a_s).clamp(-127, 127).to(torch.int8)
    return q, a_s


def quantize_act_static(x: torch.Tensor, a_scale: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize with a precomputed (calibrated) per-tensor scale
    ``a_scale`` (0-d f32): ``a_s = max(a_scale, 1e-12)``."""
    a_s = a_scale.float().clamp_min(1e-12)
    q = torch.round(x.float() / a_s).clamp(-127, 127).to(torch.int8)
    return q, a_s


def conv_w8a8_reference(q: torch.Tensor, k8: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """The int32 accumulator of the VALID conv of int8 NHWC q with the int8
    HWIO kernel k8 -> (B, Ho, Wo, O) int32: an ``F.conv2d`` in float64,
    exact because every partial sum is an integer below 2^53."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).double(),
                   k8.permute(3, 2, 0, 1).double(), stride=stride)
    return acc.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()


def rescale_reference(acc: torch.Tensor, a_s: torch.Tensor,
                      w_s: torch.Tensor, bias: Optional[torch.Tensor],
                      out_dtype: torch.dtype) -> torch.Tensor:
    """``acc * (a_s * w_s) [+ bias]`` in f32, cast to ``out_dtype``: the
    JAX op's rescale, in its order (a_s of shape (B, 1, 1, 1) or ())."""
    y = acc.float() * (a_s * w_s)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def conv_w8a8(x: torch.Tensor, kernel: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              out_dtype: torch.dtype = torch.bfloat16,
              a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized VALID conv of the already padded NHWC x with the HWIO
    float kernel: activation quant (per image, or static when a calibrated
    ``a_scale`` is given), per-channel weight quant, exact int32 conv and
    the f32 rescale -> (B, Ho, Wo, O) in ``out_dtype``. The JAX op's
    signature; Q2 and Q1 on a CUDA tensor."""
    q, a_s = quantize_act(x, 0, "zero", a_scale)
    return conv_int8(q, quantize_weights(kernel), a_s, bias, stride,
                     out_dtype)


# ---------------------------------------------------------------------------
# the serving path: weights once, then Q2 and Q1
# ---------------------------------------------------------------------------


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_weights(kernel: torch.Tensor) -> QuantWeight:
    """A (kh, kw, I, O) float kernel -> its :class:`QuantWeight`: the int8
    codes and scales of :func:`quantize_kernel_per_channel`, laid out
    [O][kh][kw][C] and zero-padded for Q1, on the kernel's device."""
    kh, kw, c, o = kernel.shape
    k8, w_s = quantize_kernel_per_channel(kernel)
    w8 = torch.zeros((_up(o, 8), kh, kw, _up(c, 16)), dtype=torch.int8,
                     device=kernel.device)
    w8[:o, :, :, :c] = k8.permute(3, 0, 1, 2)
    ws = torch.zeros(_up(o, 8), dtype=torch.float32, device=kernel.device)
    ws[:o] = w_s
    return QuantWeight(w8, ws, c, o)


def _no_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is serving only: it has no gradient "
                           "(the JAX op defines none either)")


def quantize_act_reference(x: torch.Tensor, padding: int = 0,
                           pad_type: str = "zero",
                           a_scale: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`quantize_act`: pad, then quantize (the JAX
    package's order) -> (q (B, H+2p, W+2p, C) int8, a_s)."""
    from councilx_torch.nn.blocks import pad2d

    xp = pad2d(x, padding, pad_type)
    if a_scale is None:
        return quantize_act_per_image(xp)
    return quantize_act_static(xp, a_scale)


def quantize_act(x: torch.Tensor, padding: int = 0, pad_type: str = "zero",
                 a_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC float x (B, H, W, C) -> (q, a_s): q the int8 codes of x padded
    by ``padding`` (``pad_type`` as ``nn.blocks.pad2d``), a_s the f32 scale,
    (B, 1, 1, 1) per image when ``a_scale`` is None, else ``max(a_scale,
    1e-12)`` (0-d).

    On a CUDA tensor: Q2 (``csrc/quant_act.cu``), one launch in either
    mode (static: the scale read on the card, no host sync; per image: the
    maxima and the codes in one pass over x); q then has C rounded up to 16
    channels, zeros beyond C, as Q1 takes it. ``quantize_act.launches``
    counts the launches, ``quantize_act.per_image_launches`` those of the
    per-image mode."""
    _no_grad("quantize_act", x)
    if x.device.type == "cpu":
        return quantize_act_reference(x, padding, pad_type, a_scale)
    return _quantize_act_cuda(x, padding, pad_type, a_scale)


def conv_int8_reference(q: torch.Tensor, w: QuantWeight, a_s: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, stride: int = 1,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Plain version of :func:`conv_int8`; ``out_dtype=torch.int32`` gives
    the raw accumulator."""
    c, o = w.in_channels, w.out_channels
    k8 = w.w8[:o, :, :, :c].permute(1, 2, 3, 0)
    acc = conv_w8a8_reference(q[..., :c], k8, stride)
    if out_dtype == torch.int32:
        return acc
    return rescale_reference(acc, a_s, w.w_s[:o], bias, out_dtype)


def conv_int8(q: torch.Tensor, w: QuantWeight, a_s: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """VALID conv of the int8 NHWC q (from :func:`quantize_act`) with the
    quantized kernel w: exact int32 sums, then ``acc * (a_s * w_s) +
    bias`` in f32 cast to ``out_dtype`` (bf16 or f32; int32 returns the
    accumulator) -> (B, Ho, Wo, O).

    On a CUDA tensor: Q1 (``csrc/conv_int8.cu``, TMA + ``wgmma`` s8), one
    launch; ``conv_int8.launches`` counts them."""
    _no_grad("conv_int8", bias)
    if q.device.type == "cpu":
        return conv_int8_reference(q, w, a_s, bias, stride, out_dtype)
    return _conv_int8_cuda(q, w, a_s, bias, stride, out_dtype)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _quant_act_lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("quant_act")
    fn = lib.councilx_quant_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = lib.councilx_quant_act_plan
        plan.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
        plan.restype = ctypes.c_int
    return lib


def _conv_int8_lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("conv_int8")
    fn = lib.councilx_conv_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


_quant_plans = {}


def _quant_plan(device: torch.device, dtype: int, vec: int
                ) -> Tuple[int, int]:
    """(stash bytes per block, co-resident blocks) of Q2's (dtype, vec)
    per-image kernel on ``device``, its stash sized for three blocks per
    SM, asked of the runtime once."""
    key = (device.index, dtype, vec)
    plan = _quant_plans.get(key)
    if plan is None:
        stash, cap = ctypes.c_int(0), ctypes.c_int(0)
        err = _quant_act_lib().councilx_quant_act_plan(
            dtype, vec, ctypes.byref(stash), ctypes.byref(cap))
        if err != 0 or cap.value < 1:
            raise RuntimeError(f"quantize_act: occupancy query failed with "
                               f"CUDA error {err}")
        plan = _quant_plans[key] = (stash.value, cap.value)
    return plan


def _quant_split(b: int, items: int, capacity: Optional[int]
                 ) -> Tuple[int, int]:
    """(splits, items per split) of Q2's grid: each image's ``items`` (16
    channels of a padded pixel each) in chunks of whole iterations of
    _QUANT_THREADS, none empty. Per image (``capacity``: the blocks the
    card holds at once, for the grid wait): as many chunks per image as
    ``capacity`` allows over the batch, none shorter than _QUANT_MIN_ITERS
    iterations where the image has them; one split, one block per image,
    once the images alone reach ``capacity``. Static (``capacity`` None:
    no wait, so no limit): chunks of _QUANT_MIN_ITERS iterations."""
    iters = -(-items // _QUANT_THREADS)
    if capacity is None:
        want = -(-iters // _QUANT_MIN_ITERS)
    else:
        want = 1 if b >= capacity else min(capacity // b,
                                           -(-iters // _QUANT_MIN_ITERS))
    per = -(-iters // max(1, want))
    return -(-iters // per), per * _QUANT_THREADS


def _quantize_act_cuda(x: torch.Tensor, padding: int, pad_type: str,
                       a_scale: Optional[torch.Tensor]):
    if x.dim() != 4 or x.dtype not in _ACT_DTYPES:
        raise ValueError(f"quantize_act: want 4-D bf16/f32 NHWC, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if pad_type not in _PAD_TYPES:
        raise ValueError(f"quantize_act: unknown pad_type {pad_type!r}")
    if not x.is_contiguous():
        raise ValueError("quantize_act: x must be contiguous NHWC")
    b, h, w, c = x.shape
    if padding < 0 or min(b, h, w, c) < 1 or (
            pad_type == "reflect" and padding >= min(h, w)):
        raise ValueError(f"quantize_act: pad {padding} ({pad_type}) of "
                         f"{tuple(x.shape)}")
    hp, wp, cq = h + 2 * padding, w + 2 * padding, _up(c, _QUANT_GROUP)
    if b * hp * wp * cq > _MAX_INDEX or h * w * c > _MAX_INDEX:
        raise ValueError(f"quantize_act: {tuple(x.shape)} exceeds the "
                         f"kernel's int32 indexing")
    dev = x.device
    if a_scale is not None and (a_scale.numel() != 1
                                or a_scale.device != dev):
        raise ValueError(f"quantize_act: a_scale must be one value on "
                         f"{dev}, got {tuple(a_scale.shape)} on "
                         f"{a_scale.device}")
    q = torch.empty((b, hp, wp, cq), dtype=torch.int8, device=dev)
    dtype = _ACT_DTYPES[x.dtype]
    vec = int(c % _QUANT_GROUP == 0 and x.data_ptr() % 16 == 0)
    items = hp * wp * (cq // _QUANT_GROUP)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _quant_act_lib()
        part = None
        if a_scale is None:
            stash_bytes, capacity = _quant_plan(dev, dtype, vec)
            splits, per_split = _quant_split(b, items, capacity)
            a_s = torch.empty((b, 1, 1, 1), dtype=torch.float32, device=dev)
            scale_in, stash = None, min(
                per_split // _QUANT_THREADS,
                stash_bytes // (_QUANT_THREADS * _QUANT_GROUP
                                * x.element_size()))
            if splits > 1:
                part = torch.empty((b, splits), dtype=torch.float32,
                                   device=dev)
        else:
            splits, per_split = _quant_split(b, items, None)
            a_in = a_scale.float().contiguous()
            a_s = torch.empty((), dtype=torch.float32, device=dev)
            scale_in, stash = a_in.data_ptr(), 0
        err = lib.councilx_quant_act(
            x.data_ptr(), q.data_ptr(), scale_in, a_s.data_ptr(),
            None if part is None else part.data_ptr(), int(a_scale is None),
            b, h, w, c, cq, padding, _PAD_TYPES[pad_type], dtype, vec,
            splits, per_split, stash, stream)
    if err != 0:
        raise RuntimeError(f"quantize_act: launch failed with CUDA error "
                           f"{err}")
    quantize_act.launches += 1
    quantize_act.per_image_launches += a_scale is None
    return q, a_s


def _conv_tiles(cq: int, o8: int) -> Tuple[int, int]:
    """(bytes of K per step, output channels per block) of Q1: 128-byte
    steps where C is a multiple of 128, else 64 (smaller or ragged C run
    whole steps over TMA's zero fill); 256 channels where O is above 128,
    else 128."""
    return (128 if cq % 128 == 0 else 64), (256 if o8 > 128 else 128)


def _conv_int8_cuda(q: torch.Tensor, w: QuantWeight, a_s: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    if q.dim() != 4 or q.dtype != torch.int8:
        raise ValueError(f"conv_int8: want 4-D int8 NHWC, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, hp, wp, cq = q.shape
    o8, kh, kw, c16 = w.w8.shape
    if cq != c16 or cq % 16 or o8 % 8 or w.w8.dtype != torch.int8:
        raise ValueError(f"conv_int8: q has {cq} channels, the kernel "
                         f"{tuple(w.w8.shape)} {w.w8.dtype}; both must be "
                         f"padded to a multiple of 16 (quantize_act, "
                         f"quantize_weights)")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"conv_int8: unsupported out dtype {out_dtype}")
    if not 1 <= stride <= _CONV_MAX_K or max(kh, kw) > _CONV_MAX_K or \
            hp < kh or wp < kw:
        raise ValueError(f"conv_int8: {tuple(q.shape)}, kernel {kh}x{kw}, "
                         f"stride {stride}: the kernel takes sides and "
                         f"strides up to {_CONV_MAX_K} and a non-empty "
                         f"output")
    ho, wo = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    if b * ho * wo > _MAX_INDEX or b * hp * wp * cq > _MAX_INDEX or \
            b * ho * wo * o8 > _MAX_INDEX:
        raise ValueError("conv_int8: shape exceeds the kernel's int32 "
                         "indexing")
    if a_s.numel() not in (1, b) or a_s.dtype != torch.float32:
        raise ValueError(f"conv_int8: a_s must be f32 with 1 or {b} values, "
                         f"got {tuple(a_s.shape)} {a_s.dtype}")
    tensors = [q, w.w8, w.w_s, a_s]
    if bias is not None:
        if bias.shape != (w.out_channels,):
            raise ValueError(f"conv_int8: bias {tuple(bias.shape)} for "
                             f"{w.out_channels} outputs")
        # copied (padded) only where O was rounded up or the kernel cannot
        # read it in place
        bias = bias.float()
        if o8 != w.out_channels or not bias.is_contiguous() or \
                bias.data_ptr() % 16:
            bias = F.pad(bias, (0, o8 - w.out_channels)).contiguous()
        tensors.append(bias)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"conv_int8: operands must be contiguous, "
                             f"16-byte aligned and on {q.device}")
    y = torch.empty((b, ho, wo, o8), dtype=out_dtype, device=q.device)
    bk, bn = _conv_tiles(cq, o8)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _conv_int8_lib().councilx_conv_int8(
            q.data_ptr(), w.w8.data_ptr(), a_s.data_ptr(),
            int(a_s.numel() == b and b > 1), w.w_s.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            b, hp, wp, cq, o8, kh, kw, stride, ho, wo, bk, bn,
            _OUT_DTYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv_int8: launch failed with CUDA error {err}")
    conv_int8.launches += 1
    o = w.out_channels
    return y if o == o8 else y[..., :o].contiguous()


quantize_act.launches = 0
quantize_act.per_image_launches = 0
conv_int8.launches = 0
