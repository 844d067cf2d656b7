"""3x3 VALID convolution on pre-padded NHWC input: the resblock conv.

Counterpart of ``councilx/ops/pallas_conv.py::conv3x3_valid`` with its
custom VJP. :func:`conv3x3_valid` is a ``torch.autograd.Function`` on every
device:

* forward: the hand-written Hopper kernel in ``csrc/conv3x3.cu`` on a CUDA
  tensor, :func:`conv3x3_valid_reference` on a CPU tensor;
* backward (``_bwd_rule``): d(xp) by :func:`conv3x3_dgrad` -- the same
  kernel run on the unpadded cotangent with a zero pad of 2 that its TMA
  loads supply, reading the forward's weight as the flipped, in/out-swapped
  one -- and dk by :func:`conv3x3_wgrad`, the TMA + wgmma kernel in
  ``csrc/conv3x3_wgrad.cu`` (f32 sums, returned in k's dtype). On CPU
  tensors both run their plain versions.

:func:`conv3x3_same_zero` is the same kernel at a zero pad of 1 on the
unpadded input (the "same" conv with zero padding: the interior of
``ops/pad_conv.py``'s strips engine, an XLA conv in the JAX package), with
the same VJP: its dgrad is the kernel at pad 1, its wgrad K2 with a zero pad
of 1 in its loads. Neither pads a copy. It counts its launches on
``conv3x3_valid``'s counters, as the same kernel.

Both conv calls take the kernel weight :func:`_kernel_weight` makes from
k, a relayout copy unless k is laid out as :func:`hwio_weight` makes it,
as the model's blocks do.

The kernels' TMA loads need 16-byte rows, so C and O multiples of 8. For
other channel counts (where the JAX op falls back to XLA) the wrappers
zero-pad C and O up to the next multiple of 8, launch the same kernels and
slice the result back: exact, because the zero channels add zero terms.

Nothing falls back: a CUDA input a kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from councilx_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_PIXELS = 2 ** 31 - 1   # output pixels: the kernels index them in int32
# the wgrad tiles of csrc/conv3x3_wgrad.cu: rows of the (9C, O) result,
# outputs, pixels per K' step. bf16: one tap's 128 channels x 256 outputs,
# one block per SM, so S splits of 9 ceil(C/128) ceil(O/256) tiles fill
# the SMs in one wave; f32: about _WGRAD_F32_BLOCKS blocks fill the card
_WGRAD_TILE = (128, 256, 64)
_WGRAD_F32_TILE = (64, 64, 16)
_WGRAD_F32_BLOCKS = 528      # 4 per SM of an H100
_H100_SMS = 132
# per (device index, stream): the bf16 wgrad kernel's int32 ticket counter
# of each tile, zero between launches (the kernel resets the ones it uses).
# Never dropped: a captured train step (utils/graphs.py) replays with the
# buffer of its capture stream, made by its eager warm-up on that stream
_wgrad_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 sums for bf16/f32 inputs, f64 stays f64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def conv3x3_valid_reference(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv2d`` on the channels_last view.

    xp (B, H+2, W+2, C) NHWC, k (3, 3, C, O) HWIO -> (B, H, W, O) in
    xp's dtype."""
    w = k.to(xp.dtype).permute(3, 2, 0, 1)            # HWIO -> OIHW
    y = F.conv2d(xp.permute(0, 3, 1, 2), w)
    return y.permute(0, 2, 3, 1).contiguous()


def _flip_weight(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, C, O) -> the flipped, in/out-swapped (3, 3, O, C) in dtype."""
    return k.flip((0, 1)).transpose(2, 3).to(dtype).contiguous()


def _zero_pad(t: torch.Tensor, p: int) -> torch.Tensor:
    """Zero-pad NHWC t by p on H and W (contiguous NHWC result)."""
    return F.pad(t, (0, 0, p, p, p, p)).contiguous()


def conv3x3_same_zero_reference(x: torch.Tensor,
                                k: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`conv3x3_same_zero`: x (B, H, W, C) zero-padded
    by 1, then :func:`conv3x3_valid_reference` -> (B, H, W, O)."""
    return conv3x3_valid_reference(_zero_pad(x, 1), k)


def conv3x3_dgrad_reference(g: torch.Tensor, k: torch.Tensor,
                            pad: int = 2) -> torch.Tensor:
    """Plain version of d(xp), as ``_bwd_rule`` computes it: g (B, H, W, O)
    zero-padded by 2, VALID-convolved with the flipped, in/out-swapped k ->
    (B, H+2, W+2, C) in g's dtype. ``pad`` 1: d(x) of the pad-1 forward,
    (B, H, W, C)."""
    return conv3x3_valid_reference(_zero_pad(g, pad), _flip_weight(k, g.dtype))


def conv3x3_wgrad_reference(xp: torch.Tensor, g: torch.Tensor,
                            pad: int = 0) -> torch.Tensor:
    """Plain version of dk: dk[dy,dx,c,o] = sum_{b,i,j} xp[b,i+dy,j+dx,c] *
    g[b,i,j,o], summed in f32 (f64 for f64 input) -> (3, 3, C, O); with
    ``pad`` 1, xp is the unpadded x of the pad-1 forward, zero-padded here."""
    if pad:
        xp = _zero_pad(xp, pad)
    acc = _acc_dtype(xp)
    _, hp, wp, c = xp.shape
    h, w, o = hp - 2, wp - 2, g.shape[-1]
    x32 = xp.to(acc)
    g2 = g.to(acc).reshape(-1, o)
    taps = [x32[:, dy:dy + h, dx:dx + w].reshape(-1, c).t() @ g2
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, o)


def hwio_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An OIHW (O, C, 3, 3) conv weight as k (3, 3, C, O) HWIO in dtype, in
    one copy: a view of the contiguous (3, 3, O, C) tensor that is the
    kernel weight of both conv calls, so they copy it no further."""
    wk = w.permute(2, 3, 0, 1).to(dtype,
                                  memory_format=torch.contiguous_format)
    return wk.contiguous().transpose(2, 3)


def _up8(n: int) -> int:
    """n rounded up to a multiple of 8: 16 bytes of bf16."""
    return -(-n // 8) * 8


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with its last dimension zero-padded to n (t itself if it is n)."""
    return t if t.shape[-1] == n else F.pad(t, (0, n - t.shape[-1]))


def _pad_weight(wk: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A (3, 3, R, S) kernel weight zero-padded to (3, 3, rows, cols)."""
    if tuple(wk.shape[2:]) == (rows, cols):
        return wk
    return F.pad(wk, (0, cols - wk.shape[3], 0, rows - wk.shape[2]))


def _check_channels(name: str, x: torch.Tensor, k_shape, x_axis: int):
    """x is 4-D and its channels match k's dimension ``x_axis`` (2: the
    forward's input channels; 3: the dgrad's cotangent, k's outputs), so
    that padding both to a multiple of 8 cannot hide a mismatch."""
    if x.dim() != 4 or len(k_shape) != 4 or tuple(k_shape[:2]) != (3, 3):
        raise ValueError(f"{name}: want 4-D input and a (3, 3, C, O) "
                         f"kernel, got {tuple(x.shape)} and "
                         f"{tuple(k_shape)}")
    if x.shape[-1] != k_shape[x_axis]:
        raise ValueError(f"{name}: kernel {tuple(k_shape)} does not match "
                         f"{x.shape[-1]} input channels")


def _kernel_weight(k: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, C, O) HWIO -> the conv kernel's (3, 3, O, C) weight in dtype:
    per tap, one row of input channels per output channel. The forward
    reads it so; the dgrad reads it with the taps flipped and transposed,
    which is the flipped, in/out-swapped weight. No copy when
    ``k.transpose(2, 3)`` is already contiguous in dtype."""
    return k.to(dtype).transpose(2, 3).contiguous()


def _conv_lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("conv3x3")
    fn = lib.councilx_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _wgrad_lib() -> ctypes.CDLL:
    lib = _build.load_cuda_library("conv3x3_wgrad")
    fn = lib.councilx_conv3x3_wgrad
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, xp: torch.Tensor, k_shape, other: torch.Tensor,
                pad: int = 0):
    """The kernels' gate: 4-D contiguous 16-byte aligned NHWC on one CUDA
    device, a (3, 3, C, O) weight, C and O multiples of 8 (the wrappers pad
    other counts), a non-empty output of xp zero-padded by ``pad``."""
    if xp.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xp.device}")
    if xp.dim() != 4 or len(k_shape) != 4:
        raise ValueError(f"{name}: want 4-D xp and k, got {tuple(xp.shape)} "
                         f"and {tuple(k_shape)}")
    b, hp, wp, c = xp.shape
    kh, kw, kc, o = k_shape
    if (kh, kw) != (3, 3) or kc != c:
        raise ValueError(f"{name}: kernel {tuple(k_shape)} does not match "
                         f"input channels {c}")
    if c % 8 or o % 8:
        raise ValueError(f"{name}: C={c} and O={o} must be multiples of 8")
    if min(hp, wp) + 2 * pad < 3 or b < 1:
        raise ValueError(f"{name}: empty output for {tuple(xp.shape)}")
    if xp.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {xp.dtype}")
    if not xp.is_contiguous():
        raise ValueError(f"{name}: xp must be contiguous NHWC")
    if other.device != xp.device:
        raise ValueError(f"{name}: operands on {other.device} and "
                         f"{xp.device}")
    if xp.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _launch_conv(name: str, x: torch.Tensor, wk: torch.Tensor, pad: int,
                 dgrad: bool) -> torch.Tensor:
    """The conv3x3.cu kernel on CUDA x (B, Hin, Win, C), zero-padded by
    ``pad`` inside the kernel, and the kernel weight wk
    (:func:`_kernel_weight`) in x's dtype -> (B, Hin+2pad-2, Win+2pad-2, O):
    the forward with wk (3, 3, O, C); if ``dgrad``, with wk (3, 3, C, O),
    its taps flipped and transposed."""
    b, hin, win, c = x.shape
    o = wk.shape[3] if dgrad else wk.shape[2]
    _check_cuda(name, x, (3, 3, c, o), wk, pad)
    want = (3, 3, c, o) if dgrad else (3, 3, o, c)
    if pad not in (0, 1, 2) or tuple(wk.shape) != want:
        raise ValueError(f"{name}: pad {pad}, weight {tuple(wk.shape)}")
    h, w = hin + 2 * pad - 2, win + 2 * pad - 2
    if b * h * w > _MAX_PIXELS:
        raise ValueError(f"{name}: {b * h * w} output pixels exceed the "
                         f"kernel's int32 indexing")
    if wk.dtype != x.dtype or not wk.is_contiguous() or wk.data_ptr() % 16:
        raise ValueError(f"{name}: weight must be contiguous, {x.dtype} "
                         f"and 16-byte aligned")
    y = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _conv_lib().councilx_conv3x3(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), b, hin, win, c, o,
            pad, int(dgrad), _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    return y


def _forward(xp: torch.Tensor, k: torch.Tensor, pad: int = 0) -> torch.Tensor:
    if xp.device.type == "cpu":
        y = (conv3x3_same_zero_reference(xp, k) if pad
             else conv3x3_valid_reference(xp, k))
        # not the plain version's channels_last view: the engines splice
        # their border strips into this output in place, which autograd
        # forbids on a view made inside a Function
        return y.clone() if y._is_view() else y
    return _forward_cuda(xp, k, pad)


def _forward_cuda(xp: torch.Tensor, k: torch.Tensor,
                  pad: int = 0) -> torch.Tensor:
    """The forward kernel at a zero pad of ``pad`` (0 or 1), its channels
    padded to multiples of 8."""
    name = "conv3x3_same_zero" if pad else "conv3x3_valid"
    _check_channels(name, xp, k.shape, 2)
    c, o = k.shape[2], k.shape[3]
    wk = _pad_weight(_kernel_weight(k, xp.dtype), _up8(o), _up8(c))
    y = _launch_conv(name, _pad_last(xp, _up8(c)), wk, pad, False)
    conv3x3_valid.launches += 1
    return y if o == y.shape[-1] else y[..., :o].contiguous()


def conv3x3_dgrad(g: torch.Tensor, k: torch.Tensor,
                  pad: int = 2) -> torch.Tensor:
    """d(xp) of :func:`conv3x3_valid` for the cotangent g (B, H, W, O) and
    the weight k (3, 3, C, O): (B, H+2, W+2, C) in g's dtype; with ``pad``
    1, d(x) (B, H, W, C) of :func:`conv3x3_same_zero`.

    On a CUDA tensor: the forward kernel on g with a zero pad of 2 (1) that
    its loads supply (no padded copy of g), reading the forward's kernel
    weight with the taps flipped and transposed as the flipped,
    in/out-swapped weight (no flipped copy) -- K1 run as dgrad, as
    ``_bwd_rule`` runs it; ``conv3x3_dgrad.launches`` counts those
    launches."""
    if g.device.type == "cpu":
        return conv3x3_dgrad_reference(g, k, pad)
    return _dgrad_cuda(g, k, pad)


def _dgrad_cuda(g: torch.Tensor, k: torch.Tensor,
                pad: int = 2) -> torch.Tensor:
    """The dgrad kernel, its channels padded to multiples of 8."""
    _check_channels("conv3x3_dgrad", g, k.shape, 3)
    if pad not in (1, 2):
        raise ValueError(f"conv3x3_dgrad: pad {pad}")
    c, o = k.shape[2], k.shape[3]
    wk = _pad_weight(_kernel_weight(k, g.dtype), _up8(o), _up8(c))
    dxp = _launch_conv("conv3x3_dgrad", _pad_last(g.contiguous(), _up8(o)),
                       wk, pad, True)
    conv3x3_dgrad.launches += 1
    return dxp if c == dxp.shape[-1] else dxp[..., :c].contiguous()


def _wgrad_tiles(c: int, o: int) -> int:
    """Output tiles of the bf16 wgrad kernel: one tap's 128 channels x 256
    outputs each."""
    bm, bn, _ = _WGRAD_TILE
    return 9 * -(-c // bm) * -(-o // bn)


def _wgrad_split(dtype: torch.dtype, c: int, o: int, pixels: int,
                 sms: int = _H100_SMS):
    """(splits, pixels per split) of the wgrad reduction over B*H*W, each
    split a whole number of the kernel's K' steps and none empty.

    bf16: one block per SM, so at most ``sms // tiles`` splits (one wave;
    at least 1): 7 at C = O = 256 on 132 SMs, 126 blocks. f32: about
    _WGRAD_F32_BLOCKS blocks."""
    if dtype == torch.bfloat16:
        bk = _WGRAD_TILE[2]
        want = max(1, sms // _wgrad_tiles(c, o))
    else:
        bm, bn, bk = _WGRAD_F32_TILE
        tiles = -(-9 * c // bm) * -(-o // bn)
        want = -(-_WGRAD_F32_BLOCKS // tiles)
    steps = -(-pixels // bk)
    want = max(1, min(steps, want))
    per = -(-steps // want) * bk
    return -(-pixels // per), per


def _tile_counters(device: torch.device, stream: int,
                   tiles: int) -> torch.Tensor:
    """The zeroed int32 ticket counters of the bf16 wgrad kernel for
    launches on ``stream``, at least ``tiles`` of them."""
    key = (device.index, stream)
    buf = _wgrad_counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _wgrad_counters[key] = buf
    return buf


def conv3x3_wgrad(xp: torch.Tensor, g: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32,
                  pad: int = 0) -> torch.Tensor:
    """dk of :func:`conv3x3_valid`: xp (B, H+2, W+2, C), g (B, H, W, O) ->
    (3, 3, C, O) in ``out_dtype``, summed in f32; with ``pad`` 1, dk of
    :func:`conv3x3_same_zero` from its unpadded input x (B, H, W, C).

    On a CUDA tensor: the kernel of ``csrc/conv3x3_wgrad.cu``, split over
    B*H*W with its f32 partials summed in a fixed order (bit-deterministic;
    bf16: one launch, TMA + wgmma, the sum in the same launch), the zero pad
    in its loads; ``conv3x3_wgrad.launches`` counts its calls."""
    if xp.device.type == "cpu":
        return conv3x3_wgrad_reference(xp, g, pad).to(out_dtype)
    return _wgrad_cuda(xp, g, out_dtype, pad)


def _wgrad_cuda(xp: torch.Tensor, g: torch.Tensor, out_dtype: torch.dtype,
                pad: int = 0) -> torch.Tensor:
    """The wgrad kernel, its channels padded to multiples of 8."""
    if pad not in (0, 1):
        raise ValueError(f"conv3x3_wgrad: pad {pad}")
    if xp.dim() != 4 or g.dim() != 4 or tuple(g.shape[:3]) != (
            xp.shape[0], xp.shape[1] + 2 * pad - 2,
            xp.shape[2] + 2 * pad - 2):
        raise ValueError(f"conv3x3_wgrad: g {tuple(g.shape)} does not match "
                         f"xp {tuple(xp.shape)} at pad {pad}")
    c, o = xp.shape[-1], g.shape[-1]
    dk = _launch_wgrad(_pad_last(xp, _up8(c)),
                       _pad_last(g.contiguous(), _up8(o)), out_dtype, pad)
    conv3x3_wgrad.launches += 1
    return dk if dk.shape[2:] == (c, o) else dk[:, :, :c, :o].contiguous()


def _launch_wgrad(xp: torch.Tensor, g: torch.Tensor, out_dtype: torch.dtype,
                  pad: int) -> torch.Tensor:
    """The conv3x3_wgrad.cu kernel on CUDA xp (read zero-padded by ``pad``)
    and g whose channels are multiples of 8 -> dk (3, 3, C, O) in
    ``out_dtype``."""
    b, hx, wx, c = xp.shape
    o = g.shape[-1]
    _check_cuda("conv3x3_wgrad", xp, (3, 3, c, o), g, pad)
    if g.dtype != xp.dtype:
        raise ValueError(f"conv3x3_wgrad: g is {g.dtype}, xp {xp.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"conv3x3_wgrad: unsupported out dtype {out_dtype}")
    g = g.contiguous()
    if g.data_ptr() % 16:
        raise ValueError("conv3x3_wgrad: inputs must be 16-byte aligned")
    h, w = hx + 2 * pad - 2, wx + 2 * pad - 2
    if b * h * w > _MAX_PIXELS:
        raise ValueError(f"conv3x3_wgrad: {b * h * w} pixels exceed the "
                         f"kernel's int32 indexing")
    dk = torch.empty((3, 3, c, o), dtype=out_dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        if xp.dtype == torch.bfloat16:
            tiles = _wgrad_tiles(c, o)
            sms = torch.cuda.get_device_properties(
                xp.device).multi_processor_count
            splits, per = _wgrad_split(xp.dtype, c, o, b * h * w, sms)
            part = torch.empty(
                (splits * tiles * _WGRAD_TILE[0] * _WGRAD_TILE[1]
                 if splits > 1 else 0,), dtype=torch.float32,
                device=xp.device)
            counters = _tile_counters(xp.device, stream, tiles).data_ptr()
        else:
            splits, per = _wgrad_split(xp.dtype, c, o, b * h * w)
            part = torch.empty((splits, 9 * c, o), dtype=torch.float32,
                               device=xp.device)
            counters = None
        err = _wgrad_lib().councilx_conv3x3_wgrad(
            xp.data_ptr(), g.data_ptr(), part.data_ptr(), counters,
            dk.data_ptr(), b, h, w, c, o, pad,
            _DTYPE_CODES[xp.dtype], _DTYPE_CODES[out_dtype], splits, per,
            stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad: kernel launch failed with CUDA "
                           f"error {err}")
    return dk


class Conv3x3Valid(torch.autograd.Function):
    """``conv3x3_valid`` with the JAX package's VJP (``_bwd_rule``)."""

    @staticmethod
    def forward(ctx, xp, k, save: bool):
        y = _forward(xp, k)
        if save:
            ctx.save_for_backward(xp, k)
            if xp.device.type == "cuda":
                conv3x3_valid.grad_launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        xp, k = ctx.saved_tensors
        g = g.contiguous()
        dxp = conv3x3_dgrad(g, k) if ctx.needs_input_grad[0] else None
        dk = (conv3x3_wgrad(xp, g.to(xp.dtype), k.dtype)
              if ctx.needs_input_grad[1] else None)
        return dxp, dk, None


class Conv3x3SameZero(torch.autograd.Function):
    """``conv3x3_same_zero`` with the VJP of a zero-padded conv: K1′ at pad
    1, K2 with the pad in its loads."""

    @staticmethod
    def forward(ctx, x, k, save: bool):
        y = _forward(x, k, 1)
        if save:
            ctx.save_for_backward(x, k)
            if x.device.type == "cuda":
                conv3x3_valid.grad_launches += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_dgrad(g, k, 1) if ctx.needs_input_grad[0] else None
        dk = (conv3x3_wgrad(x, g.to(x.dtype), k.dtype, 1)
              if ctx.needs_input_grad[1] else None)
        return dx, dk, None


def conv3x3_same_zero(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """"Same" 3x3 stride-1 conv with a zero pad of 1: x (B, H, W, C) NHWC
    contiguous, k (3, 3, C, O) HWIO -> (B, H, W, O) in x's dtype, f32
    accumulation; differentiable on every device. On a CUDA tensor K1 at
    pad 1 (the zero border from its TMA loads, no padded copy), counted on
    ``conv3x3_valid.launches`` (and ``grad_launches`` under autograd); a
    failed launch raises."""
    save = torch.is_grad_enabled() and (x.requires_grad or k.requires_grad)
    return Conv3x3SameZero.apply(x, k, save)


def conv3x3_valid(xp: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """VALID 3x3 stride-1 conv: xp (B, H+2, W+2, C) NHWC contiguous,
    k (3, 3, C, O) HWIO -> (B, H, W, O) in xp's dtype, f32 accumulation;
    differentiable on every device.

    The caller pads (reflect) and adds the bias, as in the JAX package.
    ``conv3x3_valid.launches`` counts forward kernel launches, and
    ``conv3x3_valid.grad_launches`` those of them made under autograd (whose
    backward launches :func:`conv3x3_dgrad` and :func:`conv3x3_wgrad`)."""
    save = torch.is_grad_enabled() and (xp.requires_grad or k.requires_grad)
    return Conv3x3Valid.apply(xp, k, save)


conv3x3_valid.launches = 0
conv3x3_valid.grad_launches = 0
conv3x3_dgrad.launches = 0
conv3x3_wgrad.launches = 0
