"""Nearest-2x upsample + 5x5 conv by exact phase decomposition: the part
of ``councilx/ops/upsample_conv.py`` the quantized decoder runs.

For output parity (a, b) the taps of the 5x5 kernel collapse onto 3x3
distinct source pixels, grouped per axis as

    parity 0:  [w0+w1, w2+w3, w4]     parity 1:  [w0, w1+w2, w3+w4]

so upsample + pad + 5x5 conv becomes ONE 3x3 conv to 4x the output
channels (the four phase kernels stacked, (a, b) major) on x padded by one
(replicate: the border it reaches is recomputed anyway), then a
depth-to-space. The 2-pixel output border, where the reflect pad of the
upsampled grid differs per parity, is recomputed by the plain path on thin
slices and spliced in; the bias comes last.

The port runs this engine only quantized (the JAX package's ``phase``
engine under ``quant``): the phase conv is W8A8 (``ops/quant.py``: Q2
writes the replicate-padded int8 codes straight from x, Q1 convolves) on
the phase kernels rounded to the compute dtype, then quantized; the border
strips stay in the compute dtype. The JAX package's other engines
(dilated, ``ln_fused``) are not ported: the port's unquantized decoder
upsamples, then convolves.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from councilx_torch.nn.blocks import pad2d, upsample_nearest_2x
from councilx_torch.ops.quant import (QuantWeight, conv_int8, quantize_act,
                                      quantize_weights)

# per parity, the 5x5 taps of one axis that sum onto each of the 3 source
# pixels (the JAX module's grouping matrices _G0, _G1)
_GROUPS: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
    ((0, 1), (2, 3), (4,)),
    ((0,), (1, 2), (3, 4)))


def upsample2x_conv5x5_reference(x: torch.Tensor, kernel: torch.Tensor,
                                 bias: Optional[torch.Tensor],
                                 pad_type: str = "reflect") -> torch.Tensor:
    """The unfused path: nearest-2x upsample -> pad(2) -> VALID 5x5 conv in
    x's dtype. x (B, H, W, Cin) NHWC, kernel (5, 5, Cin, Cout) HWIO."""
    up = pad2d(upsample_nearest_2x(x), 2, pad_type)
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(up.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.contiguous()


def _sum_taps(k: torch.Tensor, rows: Sequence[int],
              cols: Sequence[int]) -> torch.Tensor:
    """sum over cols of (sum over rows of k[r, c]), in that order: the
    order of the JAX package's einsum on the CPU, bit for bit in f32."""
    acc = None
    for c in cols:
        col = None
        for r in rows:
            col = k[r, c] if col is None else col + k[r, c]
        acc = col if acc is None else acc + col
    return acc


def phase_kernels(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (5, 5, I, O) kernel's four phase kernels stacked, (3, 3, I, 4 O)
    with phase (a, b) major on the outputs, in ``dtype``: the kernel cast to
    ``dtype``, its taps summed in f32, the sums rounded to ``dtype`` --
    what the quantized phase conv quantizes."""
    k = kernel.to(dtype).float()
    ks = [torch.stack([torch.stack([
        _sum_taps(k, _GROUPS[a][r], _GROUPS[b][c]) for c in range(3)])
        for r in range(3)]) for a in range(2) for b in range(2)]
    return torch.cat(ks, dim=-1).to(dtype)


def upsample2x_conv5x5_w8a8(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            pad_type: str = "reflect",
                            a_scale: Optional[torch.Tensor] = None,
                            qweight: Optional[QuantWeight] = None
                            ) -> torch.Tensor:
    """:func:`upsample2x_conv5x5_reference` by the phase engine with its
    phase conv W8A8 (the JAX package's ``upsample2x_conv5x5(...,
    quant=True)``), in x's dtype: activations per image, or with the static
    ``a_scale`` (the block input's calibrated absmax / 127); ``qweight`` is
    ``quantize_weights(phase_kernels(kernel, x.dtype))``, made here when
    not given. Inputs under 4x4 take the unquantized reference path, as in
    the JAX package."""
    b, h, w, _ = x.shape
    cout = kernel.shape[-1]
    if h < 4 or w < 4:
        return upsample2x_conv5x5_reference(x, kernel, bias, pad_type)
    if qweight is None:
        qweight = quantize_weights(phase_kernels(kernel, x.dtype))
    q, a_s = quantize_act(x, 1, "replicate", a_scale)
    y4 = conv_int8(q, qweight, a_s, None, 1, x.dtype)
    y = y4.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(
        b, 2 * h, 2 * w, cout)

    def ref(sl):
        return upsample2x_conv5x5_reference(sl, kernel, None, pad_type)

    # a strip from a 4-row (column) slice is exact for its first 2 output
    # rows: the taps never reach the slice's far edge
    y[:, :2] = ref(x[:, :4])[:, :2]
    y[:, -2:] = ref(x[:, -4:])[:, -2:]
    y[:, :, :2] = ref(x[:, :, :4])[:, :, :2]
    y[:, :, -2:] = ref(x[:, :, -4:])[:, :, -2:]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
