"""Building blocks of the generator (MUNIT-derived), in PyTorch.

Counterpart of ``councilx/nn/blocks.py``. Activations are NHWC at every
function, as in the JAX package; a contiguous NHWC tensor viewed with
``permute(0, 3, 1, 2)`` is a channels_last NCHW tensor, which ``F.conv2d``
takes without a copy. Parameters use the MUNIT state-dict names
(``conv.weight`` OIHW, ``fc.weight`` (out, in), ``norm.gamma`` ...), so
reference ``.pt`` files and converted JAX checkpoints load with
``load_state_dict(strict=True)``. Parameters stay float32 and are cast to
the activation's dtype at use, as the JAX modules do.

The kernel sites: the 3x3 stride-1 conv of the resblocks goes through
:func:`councilx_torch.ops.conv3x3.conv3x3_valid` (or, with ``fuse_pad``,
:func:`~councilx_torch.ops.conv3x3.conv3x3_same_zero`, the same kernel at a
zero pad of 1, inside the strips engine), every IN/AdaIN through
:func:`councilx_torch.ops.instance_norm.instance_norm`, and every reflect
or replicate pad (:func:`pad2d`) through
:func:`councilx_torch.ops.pad.pad_nhwc`. All are autograd Functions:
on CUDA tensors they launch the Hopper kernels forward and backward; on
CPU tensors their plain versions run. A block with ``quant``
(W8A8 serving, ``ops/quant.py``) runs its conv on the int8 kernels
instead, ahead of the 3x3 site, as in the JAX package. The JAX block's
conv engines are the port's too: the fused upsample + 5x5 conv
(``ops/upsample_conv.py``: dilated, phase -- its 3x3 conv on K1 -- and
``ln_fused``) and the pad-free "same" convs (``ops/pad_conv.py``:
phase_fused, phase, strips). Every other op is the plain reference op, the
spectral-norm conv and batch norm included (the JAX package runs them as
XLA ops).

State of the ``sn`` and ``bn`` norms, in MUNIT's names: a spectral-norm
block's conv is MUNIT's ``SpectralNorm(nn.Conv2d)``, so its keys are
``conv.module.weight_bar`` (OIHW), ``conv.module.bias`` and the buffers
``conv.module.weight_u`` (the JAX package's ``spectral_stats`` ``u``) and
``conv.module.weight_v`` (written by each training forward in MUNIT's
(I, kh, kw) order, read by none: the power iteration starts from ``u``). A
batch-norm block's norm is MUNIT's ``nn.BatchNorm2d``: ``norm.weight`` and
``norm.bias`` (flax's ``scale`` and ``bias``) and the buffers
``norm.running_mean``, ``norm.running_var`` (``batch_stats`` ``mean`` and
``var``) and ``norm.num_batches_tracked``.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from councilx_torch.ops.conv3x3 import conv3x3_valid, hwio_weight
from councilx_torch.ops import pad as pad_ops
from councilx_torch.ops.instance_norm import instance_norm
from councilx_torch.ops.quant import (QuantWeight, conv_int8, div127,
                                      quantize_act, quantize_weights)
from councilx_torch.utils import trace

AdaINPair = Tuple[torch.Tensor, torch.Tensor]
QUANT_MODES = ("none", "w8a8", "w8a8_calib", "w8a8_static")

# ---------------------------------------------------------------------------
# initializers — reference utils.py::weights_init, flax's scaling rules
# ---------------------------------------------------------------------------

# std of a standard normal truncated to [-2, 2] (flax's truncated_normal
# variance scaling divides by it so the kept samples have the target std)
_TRUNC_STD = 0.87962566103423978


def _fans(shape: Sequence[int]) -> Tuple[int, int]:
    """(fan_in, fan_out) of an OIHW conv or (out, in) linear weight."""
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def make_kernel_init(name: str) -> Callable[[torch.Tensor, torch.Generator],
                                            None]:
    """Weight initializer matching reference utils.py::weights_init, as
    ``fn(tensor, generator)`` filling a CPU tensor in place.

    'kaiming'   -> he_normal: truncated normal, std sqrt(2 / fan_in)
    'gaussian'  -> normal(0, 0.02)        (used for discriminators)
    'xavier'    -> normal, std sqrt(2 * 2 / (fan_in + fan_out))
    'orthogonal'-> orthogonal, gain sqrt(2)
    'default'   -> lecun_normal: truncated normal, std sqrt(1 / fan_in)
    """
    def trunc(scale):
        def fn(t, g):
            std = math.sqrt(scale / _fans(t.shape)[0]) / _TRUNC_STD
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=g)
        return fn

    if name == "kaiming":
        return trunc(2.0)
    if name == "default":
        return trunc(1.0)
    if name == "gaussian":
        return lambda t, g: nn.init.normal_(t, 0.0, 0.02, generator=g)
    if name == "xavier":
        def xavier(t, g):
            fan_in, fan_out = _fans(t.shape)
            nn.init.normal_(t, 0.0, math.sqrt(4.0 / (fan_in + fan_out)),
                            generator=g)
        return xavier
    if name == "orthogonal":
        return lambda t, g: nn.init.orthogonal_(t, math.sqrt(2.0),
                                                generator=g)
    raise ValueError(f"unknown init: {name}")


def _fill(param: torch.Tensor, fn: Callable, generator: torch.Generator):
    """Draw on the CPU from ``generator`` (device-independent streams),
    then copy into ``param`` wherever it lives."""
    tmp = torch.empty(param.shape, dtype=torch.float32)
    fn(tmp, generator)
    with torch.no_grad():
        param.copy_(tmp)


def init_parameters(module: nn.Module, init: str,
                    generator: torch.Generator) -> None:
    """Initialise every parameter of ``module`` in registration order from
    ``generator``: conv/linear weights by ``init``, biases 0, LayerNorm
    gamma ~ U[0, 1) and beta 0, PReLU slope 0.25; a spectral-norm conv's
    ``u`` ~ N(0, 1); batch norm's scale 1, bias 0 and running statistics
    (0, 1)."""
    kernel_init = make_kernel_init(init)
    for m in module.modules():
        if isinstance(m, (_Conv, _Linear)):
            _fill(m.weight, kernel_init, generator)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, SpectralConv):
            _fill(m.module.weight_bar, kernel_init, generator)
            _fill(m.module.weight_u, lambda t, g: t.normal_(generator=g),
                  generator)
            with torch.no_grad():
                m.module.bias.zero_()
                m.module.weight_v.zero_()
        elif isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, MunitLayerNorm) and m.affine:
            _fill(m.gamma, lambda t, g: t.uniform_(0.0, 1.0, generator=g),
                  generator)
            with torch.no_grad():
                m.beta.zero_()
        elif isinstance(m, _PReLU):
            with torch.no_grad():
                m.weight.fill_(0.25)


# ---------------------------------------------------------------------------
# parameter holders (MUNIT names; the forward is in the blocks)
# ---------------------------------------------------------------------------


class _Conv(nn.Module):
    """``weight`` (O, I, k, k) and ``bias`` (O,), as nn.Conv2d names them."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(
            out_dim, in_dim, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))


class _Linear(nn.Module):
    """``weight`` (out, in) and ``bias`` (out,), as nn.Linear names them."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))


class _PReLU(nn.Module):
    """Learned leaky slope (nn.PReLU's ``weight``, one shared value)."""

    def __init__(self, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def make_activation(name: str
                    ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Activation factory matching reference Conv2dBlock's choices ('prelu'
    without a learned slope uses 0.25; Conv2dBlock learns it)."""
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "prelu":
        return lambda x: torch.where(x >= 0, x, 0.25 * x)
    if name == "selu":
        return F.selu
    if name == "tanh":
        return torch.tanh
    if name == "none":
        return None
    raise ValueError(f"unknown activation: {name}")


# ---------------------------------------------------------------------------
# padding and resampling — NHWC
# ---------------------------------------------------------------------------


def pad2d(x: torch.Tensor, padding: int, pad_type: str) -> torch.Tensor:
    """Spatial padding of NHWC x, as torch's ReflectionPad2d /
    ReplicationPad2d / ZeroPad2d do it; the result is contiguous NHWC.
    Reflect and replicate run ``ops/pad.py::pad_nhwc``: the pad kernels on
    a CUDA tensor (counted as ``pad.kernel``; a dtype they do not take
    raises), the index gather on the CPU."""
    if padding == 0:
        return x
    if pad_type == "zero":
        return F.pad(x, (0, 0, padding, padding, padding, padding))
    if pad_type not in ("reflect", "replicate"):
        raise ValueError(f"unknown pad_type: {pad_type}")
    if x.device.type == "cuda":
        trace.count("pad.kernel")
    return pad_ops.pad_nhwc(x, padding, pad_type)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2) (nearest) on NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) on NHWC
    (MsImageDis's pyramid): border windows divide by their count of valid
    elements. Returns contiguous NHWC."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, count_include_pad=False)
    return y.permute(0, 2, 3, 1).contiguous()


class Upsample2x(nn.Module):
    """Parameterless slot of the decoder (the reference's nn.Upsample)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest_2x(x)


class GlobalAvgPool(nn.Module):
    """Parameterless slot of the style encoder (AdaptiveAvgPool2d(1)):
    NHWC -> (B, 1, 1, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2), keepdim=True)


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], stride: int,
               padding: int = 0) -> torch.Tensor:
    """Plain conv of NHWC x (already padded, or zero-padded by
    ``padding``) with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_mean_var(x: torch.Tensor, dims: Sequence[int],
                  stats: str = "two_pass"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and *biased* variance over ``dims`` (keepdim).

    "two_pass": the mean, then the variance around it. "one_pass":
    ``max(E[x^2] - mean^2, 0)``, which differs by float cancellation."""
    mean = x.mean(dim=tuple(dims), keepdim=True)
    if stats == "one_pass":
        ex2 = (x * x).mean(dim=tuple(dims), keepdim=True)
        var = (ex2 - mean * mean).clamp_min(0.0)
    elif stats == "two_pass":
        var = x.var(dim=tuple(dims), correction=0, keepdim=True)
    else:
        raise ValueError(f"unknown norm_stats mode: {stats}")
    return mean, var


def apply_instance_norm(y: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NHWC y: the instance-norm kernel's
    numerics (f32 two-pass statistics, one cast back) at every compute
    dtype, as the JAX package's ``use_pallas_norm`` path."""
    return instance_norm(y)


def apply_adain(y: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
    """AdaIN: instance norm, then the (B, C) style affine applied in f32
    (the reference's raw MLP outputs: weight = gamma, bias = beta)."""
    return instance_norm(y, gamma.float(), beta.float())


class AdaptiveInstanceNorm2d(nn.Module):
    """Holds the buffers the reference's AdaptiveInstanceNorm2d registers
    and never reads (its forward is batch_norm in training mode), so that
    reference state dicts load strictly. The affine comes per call."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, y: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
        return apply_adain(y, gamma, beta)


class MunitLayerNorm(nn.Module):
    """MUNIT's custom LayerNorm (networks.py::LayerNorm).

    Per-sample statistics over all of (H, W, C); ``(x - mean) / (std +
    eps)`` with the *unbiased* std; per-channel affine (gamma ~ U[0, 1),
    beta = 0 at init).

    ``precision`` ("f32" | "mixed" | "bf16"): "f32" computes in f32 and
    casts back; "mixed" takes f32 statistics and normalizes in the input
    dtype; "bf16" does everything in the input dtype. All three coincide at
    f32 input. ``stats`` picks :func:`norm_mean_var`'s scheme."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = True, precision: str = "f32",
                 stats: str = "two_pass", device=None):
        super().__init__()
        if precision not in ("f32", "mixed", "bf16"):
            raise ValueError(f"unknown in_precision: {precision}")
        self.eps = eps
        self.affine = affine
        self.precision = precision
        self.stats = stats
        if affine:
            self.gamma = nn.Parameter(torch.zeros(num_features,
                                                  device=device))
            self.beta = nn.Parameter(torch.zeros(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig = x.dtype
        xs = x if self.precision == "bf16" else x.float()
        dims = tuple(range(1, x.dim()))
        n = math.prod(x.shape[1:])
        mean, var_b = norm_mean_var(xs, dims, self.stats)
        std = torch.sqrt(var_b * (n / (n - 1)))   # unbiased, like .std()
        if self.precision == "f32":
            out = (x.float() - mean) / (std + self.eps)
            if self.affine:
                out = out * self.gamma + self.beta
            return out.to(orig)
        inv = (1.0 / (std + self.eps)).to(orig)
        out = (x - mean.to(orig)) * inv
        if self.affine:
            out = out * self.gamma.to(orig) + self.beta.to(orig)
        return out


class _SNConvParams(nn.Module):
    """The conv that MUNIT's ``SpectralNorm`` wraps, as it leaves it:
    ``weight_bar`` and ``bias`` parameters, ``weight_u``/``weight_v``
    buffers."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 device=None):
        super().__init__()
        self.weight_bar = nn.Parameter(torch.zeros(
            out_dim, in_dim, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_dim, device=device))
        self.register_buffer("weight_u", torch.zeros(out_dim, device=device))
        self.register_buffer("weight_v", torch.zeros(
            in_dim * kernel_size * kernel_size, device=device))


class SpectralConv(nn.Module):
    """Conv with spectral normalization (reference networks.py::SpectralNorm;
    ``councilx/nn/blocks.py::SpectralConv``), VALID on pre-padded NHWC x.

    Every forward runs one power iteration from the stored ``u`` on the
    kernel viewed as (out, kh*kw*in) -- the JAX package's HWIO kernel
    transposed to (O, kh, kw, I), so the same matrix as the port's OIHW
    weight permuted to (O, kh, kw, I) -- with ``u`` and ``v`` detached, eps
    1e-12, ``sigma = u @ w_mat @ v``, and convolves with ``weight / sigma``
    in x's dtype, bias added. ``u`` (and ``v``) are written back only in
    training mode, as the JAX module writes ``spectral_stats`` only when
    that collection is mutable."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 stride: int = 1, eps: float = 1e-12, device=None):
        super().__init__()
        self.module = _SNConvParams(in_dim, out_dim, kernel_size, device)
        self.stride = stride
        self.eps = eps

    def normalized_weight(self) -> torch.Tensor:
        """``weight_bar / sigma`` (f32, OIHW), differentiable through
        sigma; in training mode ``u`` and ``v`` are updated."""
        w = self.module.weight_bar
        o = w.shape[0]
        w_mat = w.permute(0, 2, 3, 1).reshape(o, -1)
        with torch.no_grad():
            wd = w_mat.detach()
            v = wd.t() @ self.module.weight_u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + self.eps)
        sigma = u @ (w_mat @ v)
        if self.training:
            with torch.no_grad():
                self.module.weight_u.copy_(u)
                kh, kw, i = w.shape[2], w.shape[3], w.shape[1]
                self.module.weight_v.copy_(
                    v.reshape(kh, kw, i).permute(2, 0, 1).reshape(-1))
        return w / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(x, self.normalized_weight().to(x.dtype),
                          self.module.bias.to(x.dtype), self.stride)


class BatchNorm(nn.Module):
    """Batch norm of NHWC y as the JAX block's ``nn.BatchNorm(
    use_running_average=False, momentum=0.9, epsilon=1e-5)`` computes it
    (MUNIT's ``nn.BatchNorm2d`` names): the batch's statistics over (N, H,
    W) in f32, in eval mode too, flax's one-pass variance ``max(E[y^2] -
    mean^2, 0)``; ``(y - mean) * (rsqrt(var + eps) * weight) + bias`` in
    f32, cast back to y's dtype. In training mode the running statistics
    become ``0.9 * old + 0.1 * batch``, with the biased batch variance (not
    ``F.batch_norm``'s unbiased one)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        x = y.float()
        mean, var = norm_mean_var(x, (0, 1, 2), "one_pass")
        if self.training:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.reshape(-1))
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.reshape(-1))
                self.num_batches_tracked += 1
        out = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (out + self.bias).to(y.dtype)


# ---------------------------------------------------------------------------
# Conv2dBlock, LinearBlock
# ---------------------------------------------------------------------------


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation (reference networks.py::Conv2dBlock).

    norm: 'in' | 'ln' | 'adain' | 'bn' | 'sn' | 'none'; 'sn' runs the conv
    as :class:`SpectralConv`, 'bn' follows the conv (with bias) with
    :class:`BatchNorm` (state names in the module docstring). An 'adain'
    block takes its
    (gamma, beta) pair as a call argument. A 3x3 stride-1 pad-1 conv runs
    on the conv3x3 kernel; the rest on ``F.conv2d``. The activation's dtype
    is the compute dtype.

    ``quant`` (serving only; the JAX block's modes): the conv runs W8A8
    (:func:`~councilx_torch.ops.quant.quantize_act` with the pad, then
    :func:`~councilx_torch.ops.quant.conv_int8`, the bias in its rescale)
    from int8 weights quantized from the f32 parameters, made once per
    weight value. "w8a8" scales each image by its own max |x|;
    "w8a8_calib" does so and folds the block input's max |x| into the
    ``act_absmax`` buffer; "w8a8_static" takes ``act_absmax / 127`` (set by
    :meth:`set_quant_stat`). The buffers are not in the state dict.

    The JAX block's engines, by its attributes and in its branch order
    (fused upsample, sn, quant, fuse_pad, plain):

    * ``upsample2x``: the block takes the input of the nearest-2x upsample.
      With ``fuse_upsample`` a 5x5 stride-1 pad-2 block (not sn) runs the
      fused op (``ops/upsample_conv.py``): ``upsample_engine`` "dilated"
      or "phase", or "ln_fused" (norm 'ln', not quantized, not prelu: the
      LN and activation folded in; otherwise "dilated"); quantized, its
      W8A8 phase engine. Else the block upsamples, then convolves.
    * ``fuse_pad`` (a stride-1 odd KxK pad K//2 block, not sn or quant):
      ``ops/pad_conv.py``. Channel-starved (C_in or C_out <= 16) with even
      H, W, norm 'in' or 'none' and not prelu, ``boundary_engine`` "auto"
      or "phase_fused" runs ``conv2d_same_phase_fused`` (norm and
      activation folded in); otherwise ``conv2d_same`` with
      ``boundary_engine`` ("phase_fused" as "auto").

    Their derived weights (the 6x6 dilated kernel, the phase kernels, the
    phase-packed kernel) are made in the autograd graph when the weight
    takes a gradient; otherwise once per weight version, dtype and device,
    as the int8 weight is."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm: str = "none",
                 activation: str = "relu", pad_type: str = "zero",
                 in_precision: str = "f32", in_stats: str = "two_pass",
                 quant: str = "none", upsample2x: bool = False,
                 fuse_upsample: bool = True,
                 upsample_engine: str = "dilated", fuse_pad: bool = False,
                 boundary_engine: str = "auto", device=None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant: {quant}")
        self.quant = quant
        self.upsample2x = upsample2x
        self.fused_upsample = (upsample2x and fuse_upsample and norm != "sn"
                               and (kernel_size, stride, padding)
                               == (5, 1, 2))
        self.upsample_engine = upsample_engine
        self.ln_fusable = (upsample_engine == "ln_fused" and norm == "ln"
                           and quant == "none" and activation != "prelu")
        self.fuse_pad = (fuse_pad and stride == 1 and kernel_size % 2 == 1
                         and padding == kernel_size // 2)
        self.boundary_engine = boundary_engine
        self.out_dim = out_dim
        self.kernel_size = kernel_size
        self.activation_name = activation
        self._derived = {}
        if quant != "none":
            self.register_buffer("act_absmax",
                                 torch.zeros((), device=device),
                                 persistent=False)
            self.register_buffer("a_scale", torch.zeros((), device=device),
                                 persistent=False)
        self._qweight: Optional[QuantWeight] = None
        self._qweight_key = None
        self._stat_set = False
        self.stride = stride
        self.padding = padding
        self.pad_type = pad_type
        self.norm_type = norm
        if norm == "sn":
            if quant != "none":
                raise ValueError("a spectral-norm block is not quantized")
            self.conv = SpectralConv(in_dim, out_dim, kernel_size, stride,
                                     device=device)
        else:
            self.conv = _Conv(in_dim, out_dim, kernel_size, device=device)
        if norm == "ln":
            self.norm = MunitLayerNorm(out_dim, precision=in_precision,
                                       stats=in_stats, device=device)
        elif norm == "adain":
            self.norm = AdaptiveInstanceNorm2d(out_dim, device=device)
        elif norm == "bn":
            self.norm = BatchNorm(out_dim, device=device)
        elif norm not in ("in", "sn", "none"):
            raise ValueError(f"unknown norm: {norm}")
        if activation == "prelu":
            self.activation = _PReLU(device=device)
        else:
            self.activation = make_activation(activation)
        self.kernel_site = (kernel_size == 3 and stride == 1
                            and padding == 1 and norm != "sn")

    def derived_weight(self, kind: str, dtype: torch.dtype) -> torch.Tensor:
        """The conv weight as an engine takes it, in ``dtype``: "dilated"
        (``upsample_conv.dilated_weight``), "phase" (the phase kernels, laid
        out for K1) or "packed" (the phase-packed HWIO kernel). In the
        autograd graph when the weight takes a gradient here; otherwise made
        again only when the weight's value (its version), place or
        ``dtype`` changed."""
        from councilx_torch.ops import pad_conv, upsample_conv

        def make():
            kernel = self.conv.weight.permute(2, 3, 1, 0).to(dtype)
            if kind == "dilated":
                return upsample_conv.dilated_weight(kernel, dtype)
            if kind == "phase":
                # K1's weight layout: transpose(2, 3) contiguous, no copy
                return upsample_conv.phase_kernels(kernel, dtype).transpose(
                    2, 3).contiguous().transpose(2, 3)
            return pad_conv._phase_packed_kernel(kernel).permute(
                3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)

        w = self.conv.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return make()
        key = (dtype, w.device, w.data_ptr(), w._version)
        hit = self._derived.get(kind)
        if hit is None or hit[0] != key:
            # a plain tensor, also when made in inference mode
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, make())
            self._derived[kind] = hit
        return hit[1]

    def set_quant_stat(self, absmax: torch.Tensor) -> None:
        """The calibrated max |x| of the block input (0-d), and with it the
        static scale ``absmax / 127`` of ``quant: w8a8_static``."""
        stat = torch.as_tensor(absmax, dtype=torch.float32).reshape(()).to(
            self.act_absmax.device)
        self.act_absmax = stat
        self.a_scale = div127(stat)
        self._stat_set = True

    def quant_weight(self, dtype: torch.dtype) -> QuantWeight:
        """The int8 weight of the quantized conv for compute ``dtype``, made
        again only when the weight's value (its version), place or
        ``dtype`` changed: the f32 parameters quantized, or for the fused
        upsample the phase kernels rounded to ``dtype``."""
        w = self.conv.weight
        key = (dtype, w.device, w.data_ptr(), w._version)
        if key != self._qweight_key:
            kernel = w.detach().permute(2, 3, 1, 0)      # OIHW -> HWIO
            if self.fused_upsample:
                from councilx_torch.ops.upsample_conv import phase_kernels
                kernel = phase_kernels(kernel, dtype)
            self._qweight = quantize_weights(kernel)
            self._qweight_key = key
        return self._qweight

    def _quant_a_scale(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The static scale (None: per-image scales); in calib mode, this
        call's max |x| folded into ``act_absmax`` first."""
        if self.quant == "w8a8":
            return None
        if self.quant == "w8a8_calib":
            self.act_absmax = torch.maximum(self.act_absmax,
                                            x.float().abs().amax())
            return None
        if not self._stat_set:
            raise RuntimeError("quant='w8a8_static' needs the block's "
                               "calibrated stat (AdaINGen.set_quant_stats)")
        return self.a_scale

    def _conv_w8a8(self, x: torch.Tensor) -> torch.Tensor:
        a_scale = self._quant_a_scale(x)
        if self.fused_upsample:
            from councilx_torch.ops.upsample_conv import \
                upsample2x_conv5x5_w8a8
            return upsample2x_conv5x5_w8a8(
                x, self.conv.weight.permute(2, 3, 1, 0).to(x.dtype),
                self.conv.bias, self.pad_type, a_scale,
                self.quant_weight(x.dtype))
        q, a_s = quantize_act(x, self.padding, self.pad_type, a_scale)
        return conv_int8(q, self.quant_weight(x.dtype), a_s, self.conv.bias,
                         self.stride, x.dtype)

    def _upsample_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The fused upsample + 5x5 conv, unquantized (``ln_fused`` apart)."""
        from councilx_torch.ops.upsample_conv import upsample2x_conv5x5
        engine = ("dilated" if self.upsample_engine == "ln_fused"
                  else self.upsample_engine)
        return upsample2x_conv5x5(
            x, self.conv.weight.permute(2, 3, 1, 0).to(x.dtype),
            self.conv.bias, self.pad_type, engine,
            self.derived_weight(engine, x.dtype))

    def _starved_fusable(self, x: torch.Tensor) -> bool:
        """The JAX block's rule for the phase_fused boundary conv."""
        starved = x.shape[-1] <= 16 or self.out_dim <= 16
        return (starved and self.kernel_size > 1 and x.shape[1] % 2 == 0
                and x.shape[2] % 2 == 0 and self.norm_type in ("in", "none")
                and self.activation_name != "prelu")

    def _conv_same(self, x: torch.Tensor) -> torch.Tensor:
        """The fuse_pad conv by ``boundary_engine`` (phase_fused handled by
        the caller)."""
        from councilx_torch.ops.pad_conv import conv2d_same, same_route
        eng = ("auto" if self.boundary_engine == "phase_fused"
               else self.boundary_engine)
        kernel = (hwio_weight(self.conv.weight, x.dtype)
                  if self.kernel_size == 3
                  else self.conv.weight.permute(2, 3, 1, 0).to(x.dtype))
        route = same_route(x.shape[1], x.shape[2], x.shape[3], self.out_dim,
                           self.kernel_size, self.pad_type, eng)
        packed = (self.derived_weight("packed", x.dtype)
                  if route == "phase" else None)
        return conv2d_same(x, kernel, self.conv.bias, self.pad_type, eng,
                           packed)

    def forward(self, x: torch.Tensor,
                adain_params: Optional[AdaINPair] = None) -> torch.Tensor:
        if self.upsample2x and not self.fused_upsample:
            x = upsample_nearest_2x(x)
        if self.fused_upsample and self.quant == "none":
            if self.ln_fusable:
                from councilx_torch.ops.upsample_conv import \
                    upsample2x_conv5x5_ln_fused
                return upsample2x_conv5x5_ln_fused(
                    x, self.conv.weight.permute(2, 3, 1, 0).to(x.dtype),
                    self.conv.bias, self.pad_type, self.norm,
                    self.activation, self.derived_weight("phase", x.dtype))
            y = self._upsample_conv(x)
        elif self.norm_type == "sn":
            y = self.conv(pad2d(x, self.padding, self.pad_type))
        elif self.quant != "none":
            y = self._conv_w8a8(x)
        elif self.fuse_pad:
            if (self._starved_fusable(x)
                    and self.boundary_engine in ("auto", "phase_fused")):
                from councilx_torch.ops.pad_conv import \
                    conv2d_same_phase_fused
                return conv2d_same_phase_fused(
                    x, self.conv.weight.permute(2, 3, 1, 0).to(x.dtype),
                    self.conv.bias, self.pad_type, self.norm_type,
                    self.activation, self.derived_weight("packed", x.dtype))
            y = self._conv_same(x)
        else:
            x = pad2d(x, self.padding, self.pad_type)
            if self.kernel_site:
                y = conv3x3_valid(x, hwio_weight(self.conv.weight, x.dtype)
                                  ) + self.conv.bias.to(x.dtype)
            else:
                y = _conv_nhwc(x, self.conv.weight.to(x.dtype),
                               self.conv.bias.to(x.dtype), self.stride)
        if self.norm_type == "in":
            y = apply_instance_norm(y)
        elif self.norm_type in ("ln", "bn"):
            y = self.norm(y)
        elif self.norm_type == "adain":
            if adain_params is None:
                raise ValueError("adain norm requires adain_params")
            y = self.norm(y, *adain_params)
        if self.activation is not None:
            y = self.activation(y)
        return y


class LinearBlock(nn.Module):
    """fc -> norm -> activation (reference networks.py::LinearBlock)."""

    def __init__(self, in_dim: int, out_dim: int, norm: str = "none",
                 activation: str = "relu", device=None):
        super().__init__()
        self.fc = _Linear(in_dim, out_dim, device=device)
        self.norm_type = norm
        if norm == "ln":
            self.norm = MunitLayerNorm(out_dim, device=device)
        elif norm not in ("in", "none"):
            raise ValueError(f"unknown norm for LinearBlock: {norm}")
        self.activation = make_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))
        if self.norm_type == "in":
            # 1-d instance norm over the feature axis per sample
            mean = y.mean(dim=-1, keepdim=True)
            var = y.var(dim=-1, correction=0, keepdim=True)
            y = (y - mean) * torch.rsqrt(var + 1e-5)
        elif self.norm_type == "ln":
            y = self.norm(y)
        if self.activation is not None:
            y = self.activation(y)
        return y


# ---------------------------------------------------------------------------
# residual stacks, MLP
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    """Two 3x3 Conv2dBlocks with an additive skip (networks.py::ResBlock).
    With norm='adain' the call takes two (gamma, beta) pairs, one per conv,
    in definition order. ``fuse_pad``: both convs fold their pad in
    (``ops/pad_conv.py``, the strips engine at the resblock's width: K1 at
    a zero pad of 1 and the border strips), as the JAX block does under
    ``resblock_fuse_pad``."""

    def __init__(self, dim: int, norm: str = "in", activation: str = "relu",
                 pad_type: str = "zero", quant: str = "none",
                 fuse_pad: bool = False, device=None):
        super().__init__()
        self.model = nn.ModuleList([
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation=activation,
                        pad_type=pad_type, quant=quant, fuse_pad=fuse_pad,
                        device=device),
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation="none",
                        pad_type=pad_type, quant=quant, fuse_pad=fuse_pad,
                        device=device)])

    def forward(self, x: torch.Tensor,
                adain_params: Optional[Sequence[AdaINPair]] = None
                ) -> torch.Tensor:
        p0 = adain_params[0] if adain_params is not None else None
        p1 = adain_params[1] if adain_params is not None else None
        return x + self.model[1](self.model[0](x, p0), p1)


class ResBlocks(nn.Module):
    """Stack of ResBlocks (networks.py::ResBlocks)."""

    def __init__(self, num_blocks: int, dim: int, norm: str = "in",
                 activation: str = "relu", pad_type: str = "zero",
                 quant: str = "none", fuse_pad: bool = False, device=None):
        super().__init__()
        self.model = nn.ModuleList([
            ResBlock(dim, norm=norm, activation=activation,
                     pad_type=pad_type, quant=quant, fuse_pad=fuse_pad,
                     device=device)
            for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor,
                adain_params: Optional[List[AdaINPair]] = None
                ) -> torch.Tensor:
        for i, blk in enumerate(self.model):
            p = (adain_params[2 * i: 2 * i + 2]
                 if adain_params is not None else None)
            x = blk(x, p)
        return x


class MLP(nn.Module):
    """Style code -> AdaIN parameters (reference networks.py::MLP): n_blk
    layers, in->dim (activ), (n_blk-2) x dim->dim (activ), dim->out."""

    def __init__(self, in_dim: int, out_dim: int, dim: int = 256,
                 n_blk: int = 3, norm: str = "none", activation: str = "relu",
                 device=None):
        super().__init__()
        layers = [LinearBlock(in_dim, dim, norm=norm, activation=activation,
                              device=device)]
        layers += [LinearBlock(dim, dim, norm=norm, activation=activation,
                               device=device) for _ in range(n_blk - 2)]
        layers += [LinearBlock(dim, out_dim, norm="none", activation="none",
                               device=device)]
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.model:
            x = layer(x)
        return x
