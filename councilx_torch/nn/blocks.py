"""Building blocks of the generator (MUNIT-derived), in PyTorch.

Counterpart of ``councilx/nn/blocks.py``. Activations are NHWC at every
function, as in the JAX package; a contiguous NHWC tensor viewed with
``permute(0, 3, 1, 2)`` is a channels_last NCHW tensor, which ``F.conv2d``
takes without a copy. Parameters use the MUNIT state-dict names
(``conv.weight`` OIHW, ``fc.weight`` (out, in), ``norm.gamma`` ...), so
reference ``.pt`` files and converted JAX checkpoints load with
``load_state_dict(strict=True)``. Parameters stay float32 and are cast to
the activation's dtype at use, as the JAX modules do.

The two kernel sites: the 3x3 stride-1 conv of the resblocks goes through
:func:`councilx_torch.ops.conv3x3.conv3x3_valid`, and every IN/AdaIN
through :func:`councilx_torch.ops.instance_norm.instance_norm`. Both are
autograd Functions: on CUDA tensors they launch the Hopper kernels forward
and backward; on CPU tensors their plain versions run. A block with
``quant`` (W8A8 serving, ``ops/quant.py``) runs its conv on the int8
kernels instead, ahead of the 3x3 site, as in the JAX package. Every other
op is the plain reference op.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from councilx_torch.ops.conv3x3 import conv3x3_valid, hwio_weight
from councilx_torch.ops.instance_norm import instance_norm
from councilx_torch.ops.quant import (QuantWeight, conv_int8, div127,
                                      quantize_act, quantize_weights)

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
    gamma ~ U[0, 1) and beta 0, PReLU slope 0.25."""
    kernel_init = make_kernel_init(init)
    for m in module.modules():
        if isinstance(m, (_Conv, _Linear)):
            _fill(m.weight, kernel_init, generator)
            with torch.no_grad():
                m.bias.zero_()
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


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, p: int, pad_type: str,
               device: torch.device) -> torch.Tensor:
    """Source index of each padded row (column). Cached: building it takes
    six small launches, which on the card cost more than the pad itself.
    Built outside inference mode, so that autograd may save it; never
    written."""
    if pad_type == "reflect" and p >= n:
        raise ValueError(f"reflect pad {p} needs a dimension > {p}, got {n}")
    with torch.inference_mode(False):
        idx = torch.arange(-p, n + p, device=device)
        if pad_type == "reflect":
            idx = idx.abs()
            return torch.where(idx >= n, 2 * (n - 1) - idx, idx)
        return idx.clamp(0, n - 1)        # replicate


def pad2d(x: torch.Tensor, padding: int, pad_type: str) -> torch.Tensor:
    """Spatial padding of NHWC x, as torch's ReflectionPad2d /
    ReplicationPad2d / ZeroPad2d do it; the result is contiguous NHWC."""
    if padding == 0:
        return x
    if pad_type == "zero":
        return F.pad(x, (0, 0, padding, padding, padding, padding))
    if pad_type not in ("reflect", "replicate"):
        raise ValueError(f"unknown pad_type: {pad_type}")
    ih = _pad_index(x.shape[1], padding, pad_type, x.device)
    iw = _pad_index(x.shape[2], padding, pad_type, x.device)
    return x[:, ih[:, None], iw[None, :]]


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


def _conv_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               stride: int) -> torch.Tensor:
    """Plain conv of already padded NHWC x with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride)
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


# ---------------------------------------------------------------------------
# Conv2dBlock, LinearBlock
# ---------------------------------------------------------------------------


class Conv2dBlock(nn.Module):
    """pad -> conv -> norm -> activation (reference networks.py::Conv2dBlock).

    norm: 'in' | 'ln' | 'adain' | 'none'. An 'adain' block takes its
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

    ``phase_upsample`` (a quantized 5x5 pad-2 block of the decoder): the
    block takes the input of the nearest-2x upsample and runs
    ``ops.upsample_conv.upsample2x_conv5x5_w8a8``, as the JAX block does
    under ``fuse_upsample``."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, norm: str = "none",
                 activation: str = "relu", pad_type: str = "zero",
                 in_precision: str = "f32", in_stats: str = "two_pass",
                 quant: str = "none", phase_upsample: bool = False,
                 device=None):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"unknown quant: {quant}")
        if phase_upsample and (quant == "none" or (kernel_size, stride,
                                                   padding) != (5, 1, 2)):
            raise ValueError("phase_upsample needs a quantized 5x5 stride-1 "
                             "pad-2 block")
        self.quant = quant
        self.phase_upsample = phase_upsample
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
        self.conv = _Conv(in_dim, out_dim, kernel_size, device=device)
        if norm == "ln":
            self.norm = MunitLayerNorm(out_dim, precision=in_precision,
                                       stats=in_stats, device=device)
        elif norm == "adain":
            self.norm = AdaptiveInstanceNorm2d(out_dim, device=device)
        elif norm not in ("in", "none"):
            raise ValueError(f"unknown norm: {norm}")
        if activation == "prelu":
            self.activation = _PReLU(device=device)
        else:
            self.activation = make_activation(activation)
        self.kernel_site = (kernel_size == 3 and stride == 1
                            and padding == 1)

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
        ``dtype`` changed: the f32 parameters quantized, or under
        ``phase_upsample`` the phase kernels rounded to ``dtype``."""
        w = self.conv.weight
        key = (dtype, w.device, w.data_ptr(), w._version)
        if key != self._qweight_key:
            kernel = w.detach().permute(2, 3, 1, 0)      # OIHW -> HWIO
            if self.phase_upsample:
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
        if self.phase_upsample:
            from councilx_torch.ops.upsample_conv import \
                upsample2x_conv5x5_w8a8
            return upsample2x_conv5x5_w8a8(
                x, self.conv.weight.permute(2, 3, 1, 0).to(x.dtype),
                self.conv.bias, self.pad_type, a_scale,
                self.quant_weight(x.dtype))
        q, a_s = quantize_act(x, self.padding, self.pad_type, a_scale)
        return conv_int8(q, self.quant_weight(x.dtype), a_s, self.conv.bias,
                         self.stride, x.dtype)

    def forward(self, x: torch.Tensor,
                adain_params: Optional[AdaINPair] = None) -> torch.Tensor:
        if self.quant != "none":
            y = self._conv_w8a8(x)
        else:
            x = pad2d(x, self.padding, self.pad_type)
            b = self.conv.bias.to(x.dtype)
            if self.kernel_site:
                y = conv3x3_valid(x, hwio_weight(self.conv.weight,
                                                 x.dtype)) + b
            else:
                y = _conv_nhwc(x, self.conv.weight.to(x.dtype), b,
                               self.stride)
        if self.norm_type == "in":
            y = apply_instance_norm(y)
        elif self.norm_type == "ln":
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
    in definition order."""

    def __init__(self, dim: int, norm: str = "in", activation: str = "relu",
                 pad_type: str = "zero", quant: str = "none", device=None):
        super().__init__()
        self.model = nn.ModuleList([
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation=activation,
                        pad_type=pad_type, quant=quant, device=device),
            Conv2dBlock(dim, dim, 3, 1, 1, norm=norm, activation="none",
                        pad_type=pad_type, quant=quant, device=device)])

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
                 quant: str = "none", device=None):
        super().__init__()
        self.model = nn.ModuleList([
            ResBlock(dim, norm=norm, activation=activation,
                     pad_type=pad_type, quant=quant, device=device)
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
