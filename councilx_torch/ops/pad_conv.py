"""Same-size KxK conv with reflect/replicate padding, without the pad copy.

Counterpart of ``councilx/ops/pad_conv.py``. The reference pads with
``nn.ReflectionPad2d`` before every conv; the direct translation
(:func:`~councilx_torch.nn.blocks.pad2d`, P1 on the card, then a VALID
conv) writes a padded copy of the activation. The engines, each exact up
to float summation order:

* ``strips``: the conv with a zero pad (no padded copy), then the P-pixel
  output border -- the only rows and columns the pad mode reaches --
  recomputed by the reference path on 2P-row (column) input slices and
  spliced in. A 3x3 interior runs on K1 at a zero pad of 1
  (:func:`~councilx_torch.ops.conv3x3.conv3x3_same_zero`); other kernel
  sizes on ``F.conv2d`` with ``padding=P``, as XLA's conv runs them in the
  JAX package.
* ``phase``: ONE stride-2 (K+1)x(K+1) conv with 4x the output channels
  (the phase-packed kernel) on the padded input, then depth-to-space: the
  shape of a channel-starved boundary conv (C_in = 3, or C_out = 3 or 4)
  becomes an ordinary conv at half resolution. Needs even H and W.
* :func:`conv2d_same_phase_fused`: the phase engine with the instance norm
  and the activation applied in the half-res layout; depth-to-space last.
  The IN is the port's IN kernel (K3) on the (B, H/2, W/2 * 4, C) view of
  the (B, H/2, W/2, 4, C) conv output: its per-(sample, channel) groups
  pool the four parities, which are equal-sized, so the statistics are the
  full-resolution ones.

Plain convs here are NHWC activations with HWIO kernels, as in the JAX
package; ``F.conv2d`` runs on the channels_last views.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from councilx_torch.nn.blocks import _conv_nhwc, pad2d
from councilx_torch.ops.conv3x3 import conv3x3_same_zero
from councilx_torch.ops.instance_norm import instance_norm


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """Plain conv of NHWC x with an HWIO kernel (cast to x's dtype), zero
    ``padding`` -> contiguous NHWC."""
    return _conv_nhwc(x, kernel.to(x.dtype).permute(3, 2, 0, 1), None,
                      stride, padding)


def depth_to_space(y4: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 4 C) with the phase (a, b) major on channels -> (B, 2h,
    2w, C): full-res pixel (2i + a, 2j + b) from y4[i, j, (2a + b) C:]."""
    b, h, w, c4 = y4.shape
    c = c4 // 4
    return y4.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, 2 * h, 2 * w, c)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


def conv2d_same_reference(x: torch.Tensor, kernel: torch.Tensor,
                          bias: Optional[torch.Tensor],
                          pad_type: str = "reflect") -> torch.Tensor:
    """The unfused path: pad2d(P) -> VALID KxK conv (stride 1, K odd)."""
    p = kernel.shape[0] // 2
    return _add_bias(conv_nhwc(pad2d(x, p, pad_type), kernel), bias)


def _phase_packed_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(K, K, I, O), K odd -> (K+1, K+1, I, 4 O) with the phase (a, b)
    major: K8[u', v', i, (a, b, o)] = K[u' - a, v' - b, i, o] (zero outside
    [0, K)). The stride-2 conv with K8 computes all four output parities
    of the stride-1 K-tap conv at once. Differentiable."""
    return torch.cat([F.pad(kernel, (0, 0, 0, 0, b, 1 - b, a, 1 - a))
                      for a in (0, 1) for b in (0, 1)], dim=-1)


def _phase_conv(x: torch.Tensor, kernel: torch.Tensor, pad_type: str,
                packed: Optional[torch.Tensor]) -> torch.Tensor:
    """The phase engine's conv: x padded by P, the stride-2 conv with the
    phase-packed kernel (``packed``, in x's dtype, or made from
    ``kernel``) -> (B, H/2, W/2, 4 O)."""
    p = kernel.shape[0] // 2
    if packed is None:
        packed = _phase_packed_kernel(kernel).to(x.dtype)
    # padded (H + 2P) minus taps (2P + 2), stride 2 -> exactly H/2 rows
    return conv_nhwc(pad2d(x, p, pad_type), packed, stride=2)


def conv2d_same_phase(x: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      pad_type: str = "reflect",
                      packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact "same" KxK stride-1 conv as ONE stride-2 (K+1)x(K+1) conv +
    depth-to-space. Requires even H, W (the caller falls back otherwise).
    ``packed``: the phase-packed kernel in x's dtype, when the caller keeps
    one."""
    y = depth_to_space(_phase_conv(x, kernel, pad_type, packed))
    return _add_bias(y, bias)


def conv2d_same_phase_fused(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            pad_type: str = "reflect", norm: str = "none",
                            act: Optional[Callable] = None,
                            packed: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Phase-packed same conv with the instance norm and the activation
    applied in the half-res phase layout; depth-to-space runs last.

    ``norm``: "none" | "in" (affine-free, on the IN kernel's numerics as at
    every IN site of the port); ``act``: an elementwise callable or None
    (elementwise ops commute with depth-to-space). Requires even H, W."""
    y4 = _phase_conv(x, kernel, pad_type, packed)
    if bias is not None:
        # channel layout is (a, b) major: index = (2a + b) * O + o
        y4 = y4 + bias.repeat(4).to(y4.dtype)
    if norm == "in":
        b, h2, w2, c4 = y4.shape
        y4 = instance_norm(y4.reshape(b, h2, w2 * 4, c4 // 4)).reshape(
            b, h2, w2, c4)
    elif norm != "none":
        raise ValueError(f"conv2d_same_phase_fused: unsupported norm {norm}")
    if act is not None:
        y4 = act(y4)
    return depth_to_space(y4)


def _conv_zero(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The "same" conv with a zero pad of K // 2: K1 at pad 1 for a 3x3
    kernel, ``F.conv2d`` otherwise."""
    if kernel.shape[0] == 3:
        return conv3x3_same_zero(x.contiguous(), kernel)
    return conv_nhwc(x, kernel, padding=kernel.shape[0] // 2)


def same_route(h: int, w: int, c_in: int, c_out: int, k: int,
               pad_type: str, engine: str) -> str:
    """The route :func:`conv2d_same` takes for an (h, w, c_in) input and a
    (k, k, c_in, c_out) kernel: "reference", "phase", "zero" (the
    zero-padded conv alone) or "strips"."""
    p = k // 2
    if engine == "reference":
        return "reference"
    even = h % 2 == 0 and w % 2 == 0
    if engine == "auto":
        starved = c_in <= 16 or c_out <= 16
        engine = "phase" if starved and even else "strips"
    if engine == "phase" and even and p > 0:
        return "phase"
    if pad_type == "zero" or p == 0:
        return "zero"
    if h < 2 * p or w < 2 * p:
        return "reference"
    return "strips"


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor], pad_type: str = "reflect",
                engine: str = "auto",
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused, exact equivalent of :func:`conv2d_same_reference`.

    x (B, H, W, C_in) NHWC, kernel (K, K, C_in, C_out) HWIO, K odd, stride
    1, P = K // 2. Engines, as the JAX function picks them
    (:func:`same_route`):

    - ``"phase"``: :func:`conv2d_same_phase`; needs even H and W;
    - ``"strips"``: the zero-padded conv + the P-pixel border recomputed on
      2P-row (column) slices (a strip's taps never reach its fake far
      edge, and its near-side pad reads only rows inside the slice);
    - ``"auto"``: phase when channel-starved (C_in <= 16 or C_out <= 16)
      and H, W are even, else strips;
    - ``"reference"``: :func:`conv2d_same_reference`.

    The JAX function's shape fallbacks: odd H or W under "phase" take
    strips; a zero pad (or P = 0) takes the zero-padded conv; H or W under
    2P takes the reference path."""
    kh, kw = kernel.shape[0], kernel.shape[1]
    if kh != kw or kh % 2 != 1:
        raise ValueError(f"conv2d_same needs an odd square kernel, got "
                         f"{tuple(kernel.shape[:2])}")
    p = kh // 2
    route = same_route(x.shape[1], x.shape[2], x.shape[3], kernel.shape[3],
                       kh, pad_type, engine)
    if route == "reference":
        return conv2d_same_reference(x, kernel, bias, pad_type)
    if route == "phase":
        return conv2d_same_phase(x, kernel, bias, pad_type, packed)
    y = _conv_zero(x, kernel)
    if route == "strips":
        def ref(sl):
            return conv2d_same_reference(sl, kernel, None, pad_type)

        # the JAX function's splice order: left/right own the corners
        y[:, :p] = ref(x[:, :2 * p])[:, :p]
        y[:, -p:] = ref(x[:, -2 * p:])[:, -p:]
        y[:, :, :p] = ref(x[:, :, :2 * p])[:, :, :p]
        y[:, :, -p:] = ref(x[:, :, -2 * p:])[:, :, -p:]
    return _add_bias(y, bias)
