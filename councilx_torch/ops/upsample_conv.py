"""Fused nearest-2x upsample + 5x5 conv: ``councilx/ops/upsample_conv.py``.

The reference decoder upsamples (nearest) and then runs a reflect-padded
5x5 conv. The engines here compute the same function, exact up to float
summation order, without the upsampled copy:

* ``"dilated"`` (the default): nearest-up(x) = zero-insert(x) convolved
  with ones(2, 2), so upsample + 5x5 conv is ONE conv of the zero-inserted
  x with the 6x6 kernel ones(2, 2) * w (:func:`_dilated_kernel`): the JAX
  package's ``lhs_dilation=2`` conv, which is ``F.conv_transpose2d`` with
  stride 2, padding 2 and that kernel flipped (for output row i it reads
  the 6x6 taps u with (i + u - 3) / 2 a whole source row, as the JAX conv's
  padding of 3 on the (2H - 1)-row dilated grid does).
* ``"phase"``: for output parity (a, b) the 5x5 taps collapse onto 3x3
  distinct source pixels, grouped per axis as

      parity 0:  [w0+w1, w2+w3, w4]     parity 1:  [w0, w1+w2, w3+w4]

  so the op is ONE 3x3 conv to 4x the output channels (the four phase
  kernels stacked, (a, b) major) on x replicate-padded by 1, then a
  depth-to-space. The 3x3 conv runs on K1 (``ops/conv3x3.py``); under
  ``quant`` it is W8A8 (Q2 writes the replicate-padded int8 codes straight
  from x, Q1 convolves) on the phase kernels rounded to the compute dtype.
* ``"ln_fused"`` (:func:`upsample2x_conv5x5_ln_fused`): the phase conv
  with MUNIT's LayerNorm, its affine and the activation applied in the
  half-res phase layout, depth-to-space last.

Either interior engine is exact except on the 2-pixel output border, where
the reflect pad of the upsampled grid differs per parity: it is recomputed
by the plain path on thin slices and spliced in; the bias comes last.
Inputs under 4x4 take the plain path, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from councilx_torch.nn.blocks import (MunitLayerNorm, norm_mean_var, pad2d,
                                      upsample_nearest_2x)
from councilx_torch.ops.conv3x3 import conv3x3_valid
from councilx_torch.ops.pad_conv import depth_to_space
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


def _dilated_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(5, 5, I, O) -> (6, 6, I, O) f32: ones(2, 2) fully convolved with the
    5x5 taps, summed in f32 in the JAX function's order. Differentiable."""
    k = kernel.float()
    k6 = None
    for dy in (0, 1):
        for dx in (0, 1):
            t = F.pad(k, (0, 0, 0, 0, dx, 1 - dx, dy, 1 - dy))
            k6 = t if k6 is None else k6 + t
    return k6


def dilated_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dilated engine's ``F.conv_transpose2d`` weight (I, O, 6, 6) in
    ``dtype``: :func:`_dilated_kernel` rounded to ``dtype``, its taps
    flipped. ``kernel`` (5, 5, I, O) is in the compute dtype already, as the
    JAX block casts it."""
    return _dilated_kernel(kernel).to(dtype).flip((0, 1)).permute(2, 3, 0, 1)


def _border_strips(y: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor,
                   pad_type: str) -> torch.Tensor:
    """y with its 2-pixel full-res border replaced by the plain path's on
    thin slices: a strip from a 4-row (column) slice is exact for its first
    2 output rows, the taps never reaching the slice's far edge.
    Left/right last: they own the corners, as in the JAX function."""
    def ref(sl):
        return upsample2x_conv5x5_reference(sl, kernel, None, pad_type)

    y[:, :2] = ref(x[:, :4])[:, :2]
    y[:, -2:] = ref(x[:, -4:])[:, -2:]
    y[:, :, :2] = ref(x[:, :, :4])[:, :, :2]
    y[:, :, -2:] = ref(x[:, :, -4:])[:, :, -2:]
    return y


def upsample2x_conv5x5(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor],
                       pad_type: str = "reflect", engine: str = "dilated",
                       derived: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Fused, exact equivalent of :func:`upsample2x_conv5x5_reference`, by
    the ``"dilated"`` or the ``"phase"`` engine (module docstring), in x's
    dtype. x (B, H, W, I) NHWC, kernel (5, 5, I, O) HWIO in x's dtype.
    ``derived``: the engine's weight made ahead (:func:`dilated_weight`;
    :func:`phase_kernels`), else made here."""
    if x.shape[1] < 4 or x.shape[2] < 4:
        return upsample2x_conv5x5_reference(x, kernel, bias, pad_type)
    if engine == "dilated":
        wt = dilated_weight(kernel, x.dtype) if derived is None else derived
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2,
                               padding=2).permute(0, 2, 3, 1)
    elif engine == "phase":
        k4 = phase_kernels(kernel, x.dtype) if derived is None else derived
        y = depth_to_space(conv3x3_valid(pad2d(x, 1, "replicate"), k4))
    else:
        raise ValueError(f"unknown upsample engine: {engine}")
    y = _border_strips(y, x, kernel, pad_type)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _strip_to_phase_row(t: torch.Tensor) -> torch.Tensor:
    """Full-res 2-row strip (B, 2, 2W, C) -> ONE phase-layout row (B, 1, W,
    4C), (a, b)-major channels: full-res (2i + a, 2j + b) is phase [i, j,
    (2a + b) C + o]."""
    b, _, wf, c = t.shape
    t = t.reshape(b, 2, wf // 2, 2, c).permute(0, 2, 1, 3, 4)
    return t.reshape(b, 1, wf // 2, 4 * c)


def _strip_to_phase_col(t: torch.Tensor) -> torch.Tensor:
    """Full-res 2-column strip (B, 2H, 2, C) -> ONE phase-layout column
    (B, H, 1, 4C) (see :func:`_strip_to_phase_row`)."""
    b, hf, _, c = t.shape
    return t.reshape(b, hf // 2, 1, 4 * c)


def _ln_affine_act(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float, ln_precision: str, ln_stats: str, act,
                   tiled: bool) -> torch.Tensor:
    """MUNIT LayerNorm + per-channel affine + activation on y, whose channel
    axis is the plain C (``tiled`` False) or the (a, b)-major phase layout
    4C (the affine repeated 4x); precision and stats as
    :class:`~councilx_torch.nn.blocks.MunitLayerNorm` computes them."""
    g = gamma.repeat(4) if tiled else gamma
    bt = beta.repeat(4) if tiled else beta
    orig = y.dtype
    ys = y if ln_precision == "bf16" else y.float()
    dims = tuple(range(1, y.dim()))
    n = 1
    for d in dims:
        n *= y.shape[d]
    mean, var_b = norm_mean_var(ys, dims, ln_stats)
    std = torch.sqrt(var_b * (n / (n - 1)))     # unbiased, like .std()
    if ln_precision == "f32":
        out = (y.float() - mean) / (std + eps)
        out = (out * g + bt).to(orig)
    else:
        inv = (1.0 / (std + eps)).to(orig)
        out = (y - mean.to(orig)) * inv
        out = out * g.to(orig) + bt.to(orig)
    return act(out) if act is not None else out


def upsample2x_conv5x5_ln_fused(x: torch.Tensor, kernel: torch.Tensor,
                                bias: Optional[torch.Tensor], pad_type: str,
                                norm: MunitLayerNorm, act=None,
                                derived: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Upsample + 5x5 conv + MUNIT LayerNorm (``norm``'s gamma, beta, eps,
    precision and stats) + activation, with the LN applied in the half-res
    phase layout and depth-to-space last.

    The LN normalizes each sample over all of (H, W, C), and the phase
    layout (B, H, W, 4C) holds the same elements, so its statistics are the
    full-res ones; the affine repeats 4x over the phase channels. The
    border strips are spliced into the phase tensor (one phase row or
    column per side) before the statistics. The phase conv runs on K1;
    ``derived``: its :func:`phase_kernels`, when made ahead."""
    args = (norm.gamma, norm.beta, norm.eps, norm.precision, norm.stats, act)
    if x.shape[1] < 4 or x.shape[2] < 4:
        y = upsample2x_conv5x5_reference(x, kernel, bias, pad_type)
        return _ln_affine_act(y, *args, tiled=False)
    k4 = phase_kernels(kernel, x.dtype) if derived is None else derived
    y4 = conv3x3_valid(pad2d(x, 1, "replicate"), k4)

    def ref(sl):
        return upsample2x_conv5x5_reference(sl, kernel, None, pad_type)

    y4[:, :1] = _strip_to_phase_row(ref(x[:, :4])[:, :2])
    y4[:, -1:] = _strip_to_phase_row(ref(x[:, -4:])[:, -2:])
    y4[:, :, :1] = _strip_to_phase_col(ref(x[:, :, :4])[:, :, :2])
    y4[:, :, -1:] = _strip_to_phase_col(ref(x[:, :, -4:])[:, :, -2:])
    if bias is not None:
        y4 = y4 + bias.repeat(4).to(y4.dtype)
    return depth_to_space(_ln_affine_act(y4, *args, tiled=True))


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
    if x.shape[1] < 4 or x.shape[2] < 4:
        return upsample2x_conv5x5_reference(x, kernel, bias, pad_type)
    if qweight is None:
        qweight = quantize_weights(phase_kernels(kernel, x.dtype))
    q, a_s = quantize_act(x, 1, "replicate", a_scale)
    y = depth_to_space(conv_int8(q, qweight, a_s, None, 1, x.dtype))
    y = _border_strips(y, x, kernel, pad_type)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
