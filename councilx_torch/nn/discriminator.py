"""Multi-scale PatchGAN discriminator (reference networks.py::MsImageDis).

Counterpart of ``councilx/nn/discriminator.py``, NHWC throughout.
``num_scales`` PatchGAN CNNs run on an average-pool image pyramid
(:func:`avg_pool_3x3_s2` between scales). Each CNN: ``n_layer`` 4x4
stride-2 reflect-padded convs with LeakyReLU 0.2 and channel doubling, then
a 1x1 conv to one logit map. The same module is the council discriminator,
with ``input_dim = 2 * channels`` when the council is conditional.

Parameter names are MUNIT's (``cnns.{s}.{l}.conv.weight``,
``cnns.{s}.{n_layer}.weight``), so reference state dicts and converted JAX
trees load with ``load_state_dict(strict=True)``. No kernel site: the JAX
package runs these convs as XLA convs, so ``F.conv2d`` runs them here.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from councilx_torch.nn.blocks import Conv2dBlock, _Conv, _conv_nhwc, \
    avg_pool_3x3_s2


class MsImageDis(nn.Module):
    """Reference: networks.py::MsImageDis. ``forward`` returns the list of
    per-scale logit maps (B, h, w, 1), in the input's dtype."""

    def __init__(self, input_dim: int = 3, dim: int = 64, n_layer: int = 4,
                 norm: str = "none", activ: str = "lrelu",
                 num_scales: int = 3, pad_type: str = "reflect",
                 device=None):
        super().__init__()
        if norm != "none":
            raise NotImplementedError(
                f"dis.norm={norm!r} is not ported yet to councilx_torch "
                "(SpectralConv/BatchNorm); every shipped config uses 'none'")
        self.input_dim = input_dim
        self.n_layer = n_layer
        self.cnns = nn.ModuleList()
        for _ in range(num_scales):
            d = dim
            layers: List[nn.Module] = [Conv2dBlock(
                input_dim, d, 4, 2, 1, norm="none", activation=activ,
                pad_type=pad_type, device=device)]
            for _ in range(n_layer - 1):
                layers.append(Conv2dBlock(d, 2 * d, 4, 2, 1, norm="none",
                                          activation=activ,
                                          pad_type=pad_type, device=device))
                d *= 2
            layers.append(_Conv(d, 1, 1, device=device))
            self.cnns.append(nn.ModuleList(layers))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outputs = []
        for s, cnn in enumerate(self.cnns):
            h = x
            for layer in cnn[:-1]:
                h = layer(h)
            final = cnn[-1]
            outputs.append(_conv_nhwc(h, final.weight.to(h.dtype),
                                      final.bias.to(h.dtype), 1))
            if s != len(self.cnns) - 1:
                x = avg_pool_3x3_s2(x)
        return outputs
