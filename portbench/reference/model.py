"""Council-GAN's networks in plain PyTorch: MUNIT's AdaINGen and MsImageDis.

The benchmark's reference. It follows the published layer equations (MUNIT
``networks.py``, as Council-GAN uses it) and computes them directly, in
float32, NCHW inside:

  ContentEncoder  reflect pad 3, 7x7 conv, IN, ReLU; n_downsample x [reflect
                  pad 1, 4x4 stride-2 conv, IN, ReLU] (channels doubling);
                  n_res ResBlocks [pad 1, 3x3 conv, IN, ReLU; pad 1, 3x3
                  conv, IN] with an additive skip
  StyleEncoder    7x7 conv, ReLU; 2 x 4x4 stride-2 doubling convs, ReLU;
                  (n_downsample - 2) x 4x4 stride-2 convs; global average
                  pool; 1x1 conv to style_dim
  Decoder         n_res AdaIN ResBlocks; n_downsample x [nearest 2x
                  upsample, reflect pad 2, 5x5 conv, MUNIT LayerNorm, ReLU];
                  reflect pad 3, 7x7 conv, tanh
  MLP             style code -> (beta, gamma) of every AdaIN layer, flat
  MsImageDis      num_scales PatchGANs on an average-pool pyramid, each
                  n_layer x [reflect pad 1, 4x4 stride-2 conv, LeakyReLU
                  0.2] and a 1x1 conv to one logit map

IN is ``(x - mean) * rsqrt(var + 1e-5)`` with the biased variance; MUNIT's
LayerNorm is ``(x - mean) / (std + 1e-5)`` over (C, H, W) with the unbiased
std and a per-channel affine. With a focus mask the decoder emits one more
channel, which ``(m + 1) / 2`` maps to [0, 1].

Parameter and buffer names are MUNIT's state-dict keys, so one state dict
loads into this model and into the program under test alike.

``q`` rounds the operands of every conv and linear layer. The reference
runs with none; the precision control of ``portbench/tests`` passes an
fp8 rounding, so that the same equations run one precision below what the
program is asked for.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Conv(nn.Module):
    """``weight`` (O, I, k, k) and ``bias`` (O,), as nn.Conv2d names them."""

    def __init__(self, i: int, o: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(o, i, k, k))
        self.bias = nn.Parameter(torch.zeros(o))


class Linear(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(o, i))
        self.bias = nn.Parameter(torch.zeros(o))


class Slot(nn.Module):
    """A parameterless layer of MUNIT's Sequentials (upsample, pooling):
    it holds its index, so that the later layers keep MUNIT's keys."""


class LayerNorm(nn.Module):
    """MUNIT's LayerNorm (``gamma``, ``beta``)."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        mean = flat.mean(1).view(-1, 1, 1, 1)
        std = flat.std(1, correction=1).view(-1, 1, 1, 1)
        y = (x - mean) / (std + 1e-5)
        return y * self.gamma.view(1, -1, 1, 1) + self.beta.view(1, -1, 1, 1)


class AdaINBuffers(nn.Module):
    """MUNIT's AdaptiveInstanceNorm2d: buffers it registers and never reads;
    the affine comes with each call."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class Block(nn.Module):
    """Reflect pad, conv, norm ("in", "ln", "adain" or "none"), activation
    ("relu", "lrelu", "tanh" or "none"); ``upsample``: a nearest 2x
    upsample first."""

    def __init__(self, i: int, o: int, k: int, stride: int, pad: int,
                 norm: str, act: str, q: Round, upsample: bool = False):
        super().__init__()
        self.conv = Conv(i, o, k)
        if norm == "ln":
            self.norm = LayerNorm(o)
        elif norm == "adain":
            self.norm = AdaINBuffers(o)
        self.kind, self.act = norm, act
        self.stride, self.pad, self.upsample = stride, pad, upsample
        self.q = q or _same

    def forward(self, x: torch.Tensor, adain=None) -> torch.Tensor:
        if self.upsample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        y = F.conv2d(self.q(x), self.q(self.conv.weight), self.conv.bias,
                     self.stride)
        if self.kind == "in":
            y = instance_norm(y)
        elif self.kind == "adain":
            gamma, beta = adain
            y = instance_norm(y) * gamma[:, :, None, None] \
                + beta[:, :, None, None]
        elif self.kind == "ln":
            y = self.norm(y)
        if self.act == "relu":
            y = F.relu(y)
        elif self.act == "lrelu":
            y = F.leaky_relu(y, 0.2)
        elif self.act == "tanh":
            y = torch.tanh(y)
        return y


class ResBlock(nn.Module):
    def __init__(self, c: int, norm: str, q: Round):
        super().__init__()
        self.model = nn.ModuleList([Block(c, c, 3, 1, 1, norm, "relu", q),
                                    Block(c, c, 3, 1, 1, norm, "none", q)])

    def forward(self, x, adain=None):
        a0, a1 = adain if adain is not None else (None, None)
        return x + self.model[1](self.model[0](x, a0), a1)


class ResBlocks(nn.Module):
    def __init__(self, n: int, c: int, norm: str, q: Round):
        super().__init__()
        self.model = nn.ModuleList([ResBlock(c, norm, q) for _ in range(n)])

    def forward(self, x, adain=None):
        for i, blk in enumerate(self.model):
            x = blk(x, adain[2 * i:2 * i + 2] if adain is not None else None)
        return x


class ContentEncoder(nn.Module):
    def __init__(self, g: dict, q: Round):
        super().__init__()
        d = g["dim"]
        layers: List[nn.Module] = [Block(3, d, 7, 1, 3, "in", "relu", q)]
        for _ in range(g["n_downsample"]):
            layers.append(Block(d, 2 * d, 4, 2, 1, "in", "relu", q))
            d *= 2
        layers.append(ResBlocks(g["n_res"], d, "in", q))
        self.model = nn.ModuleList(layers)
        self.output_dim = d

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return x


class StyleEncoder(nn.Module):
    def __init__(self, g: dict, q: Round):
        super().__init__()
        d = g["dim"]
        layers: List[nn.Module] = [Block(3, d, 7, 1, 3, "none", "relu", q)]
        for _ in range(2):
            layers.append(Block(d, 2 * d, 4, 2, 1, "none", "relu", q))
            d *= 2
        for _ in range(g["n_downsample"] - 2):
            layers.append(Block(d, d, 4, 2, 1, "none", "relu", q))
        layers += [Slot(), Conv(d, g["style_dim"], 1)]
        self.model = nn.ModuleList(layers)
        self.q = q or _same

    def forward(self, x):
        for layer in self.model[:-2]:
            x = layer(x)
        x = x.mean(dim=(2, 3), keepdim=True)
        final = self.model[-1]
        return F.conv2d(self.q(x), self.q(final.weight), final.bias).flatten(1)


class Decoder(nn.Module):
    def __init__(self, g: dict, c: int, out_dim: int, q: Round):
        super().__init__()
        self.dim, self.n_res = c, g["n_res"]
        layers: List[nn.Module] = [ResBlocks(g["n_res"], c, "adain", q)]
        for _ in range(g["n_downsample"]):
            layers += [Slot(), Block(c, c // 2, 5, 1, 2, "ln", "relu", q,
                                     upsample=True)]
            c //= 2
        layers.append(Block(c, out_dim, 7, 1, 3, "none", "tanh", q))
        self.model = nn.ModuleList(layers)

    def forward(self, x, adain_vec):
        d = self.dim
        # per AdaIN layer, in order: beta (MUNIT's bias), then gamma
        pairs = [(adain_vec[:, (2 * i + 1) * d:(2 * i + 2) * d],
                  adain_vec[:, 2 * i * d:(2 * i + 1) * d])
                 for i in range(2 * self.n_res)]
        x = self.model[0](x, pairs)
        for layer in self.model[1:]:
            if not isinstance(layer, Slot):
                x = layer(x)
        return x


class MLP(nn.Module):
    def __init__(self, i: int, o: int, dim: int, n_blk: int, q: Round):
        super().__init__()
        sizes = [i] + [dim] * (n_blk - 1) + [o]
        self.model = nn.ModuleList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            blk = nn.Module()
            blk.fc = Linear(a, b)
            self.model.append(blk)
        self.q = q or _same

    def forward(self, x):
        for i, blk in enumerate(self.model):
            x = F.linear(self.q(x), self.q(blk.fc.weight), blk.fc.bias)
            if i < len(self.model) - 1:
                x = F.relu(x)
        return x


class AdaINGen(nn.Module):
    """One council member's generator. Images are NHWC in [-1, 1], as the
    program takes them."""

    def __init__(self, g: dict, focus: bool, q: Round = None):
        super().__init__()
        self.enc_content = ContentEncoder(g, q)
        self.enc_style = StyleEncoder(g, q)
        c = self.enc_content.output_dim
        self.dec = Decoder(g, c, 4 if focus else 3, q)
        self.mlp = MLP(g["style_dim"], 2 * c * 2 * g["n_res"], g["mlp_dim"],
                       g.get("mlp_n_blk", 3), q)
        self.focus = focus

    def encode_content(self, x_nhwc):
        return self.enc_content(x_nhwc.permute(0, 3, 1, 2))

    def encode_style(self, x_nhwc):
        return self.enc_style(x_nhwc.permute(0, 3, 1, 2))

    def decode(self, content, style):
        """-> NHWC decoder output (3 or 4 channels)."""
        return self.dec(content, self.mlp(style)).permute(0, 2, 3, 1)

    def composite(self, out, x_nhwc):
        """-> (image, mask | None): with the focus mask, ``mask * rgb +
        (1 - mask) * x``."""
        if not self.focus:
            return out, None
        mask = (out[..., 3:4] + 1.0) * 0.5
        return mask * out[..., :3] + (1.0 - mask) * x_nhwc, mask

    def translate(self, x_nhwc, z):
        """-> (image NHWC, mask | None, content code)."""
        c = self.encode_content(x_nhwc)
        img, mask = self.composite(self.decode(c, z), x_nhwc)
        return img, mask, c


class MsImageDis(nn.Module):
    """NHWC images in; the list of per-scale logit maps (B, 1, h, w) out."""

    def __init__(self, d: dict, input_dim: int, q: Round = None):
        super().__init__()
        self.cnns = nn.ModuleList()
        for _ in range(d["num_scales"]):
            c = d["dim"]
            layers: List[nn.Module] = [
                Block(input_dim, c, 4, 2, 1, "none", "lrelu", q)]
            for _ in range(d["n_layer"] - 1):
                layers.append(Block(c, 2 * c, 4, 2, 1, "none", "lrelu", q))
                c *= 2
            layers.append(Conv(c, 1, 1))
            self.cnns.append(nn.ModuleList(layers))
        self.q = q or _same

    def forward(self, x_nhwc):
        x = x_nhwc.permute(0, 3, 1, 2)
        outs = []
        for s, cnn in enumerate(self.cnns):
            h = x
            for layer in cnn[:-1]:
                h = layer(h)
            outs.append(F.conv2d(self.q(h), self.q(cnn[-1].weight),
                                 cnn[-1].bias))
            if s != len(self.cnns) - 1:
                x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)
        return outs


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8: scale, clamp, round half up."""
    return (((img + 1.0) * 0.5).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def from_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1] float32, ``(x - 127.5) / 127.5``."""
    return (x_u8.to(torch.float32) - 127.5) / 127.5
