"""Instance norm with an optional AdaIN affine, on NHWC input.

Counterpart of ``councilx/ops/pallas_norm.py::instance_norm_pallas``
(forward: ``_fwd_kernel`` and ``_fwd_affine_kernel``). On a CUDA tensor it
launches the Triton kernel in ``councilx_torch/csrc/instance_norm_triton.py``
at every shape (the JAX package's VMEM gate is a TPU fact, not semantics);
on a CPU tensor it runs the plain version :func:`instance_norm_reference`.
Nothing falls back: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from councilx_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
_TILE = 8192            # elements per (BLOCK_HW, BLOCK_C) tile
_TARGET_PROGRAMS = 128  # about one program per SM of an H100


def instance_norm_reference(x: torch.Tensor,
                            gamma: Optional[torch.Tensor] = None,
                            beta: Optional[torch.Tensor] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version. x (B, H, W, C); gamma/beta (B, C) or None.

    f32 statistics over (H, W): the mean, then the biased variance of the
    centred values; ``rsqrt(var + eps)``; the affine in f32; one cast back
    to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=(1, 2), keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.float()[:, None, None, :] + beta.float()[:, None, None, :]
    return y.to(x.dtype)


def _block_c(b: int, c: int) -> int:
    """Channels per program: the widest power of two (8 to 64) that still
    gives about _TARGET_PROGRAMS programs, so small batches fill the card."""
    bc = 64
    while bc > 8 and b * -(-c // bc) < _TARGET_PROGRAMS:
        bc //= 2
    return bc


def instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over (H, W) of NHWC x, then ``* gamma + beta`` per
    (sample, channel) when given ((B, C), applied in f32).

    ``instance_norm.launches`` counts kernel launches;
    ``instance_norm.affine_launches`` those of the affine (AdaIN) variant."""
    if (gamma is None) != (beta is None):
        raise ValueError("gamma and beta must be given together")
    if x.device.type == "cpu":
        return instance_norm_reference(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm: want NHWC, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"instance_norm: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm: x must be contiguous NHWC")
    b, h, w, c = x.shape
    if b * h * w * c == 0:
        raise ValueError(f"instance_norm: empty input {tuple(x.shape)}")
    if gamma is not None:
        if gamma.shape != (b, c) or beta.shape != (b, c):
            raise ValueError(f"instance_norm: gamma/beta must be {(b, c)}, "
                             f"got {tuple(gamma.shape)}/{tuple(beta.shape)}")
        if gamma.device != x.device or beta.device != x.device:
            raise ValueError("instance_norm: gamma/beta on another device")
        gamma = gamma.float().contiguous()
        beta = beta.float().contiguous()
    y = torch.empty_like(x)
    kernels = _build.load_triton_module("instance_norm_triton")
    bc = _block_c(b, c)
    grid = (b, -(-c // bc))
    with torch.cuda.device(x.device):
        kernels.instance_norm_kernel[grid](
            x, y, gamma if gamma is not None else y,
            beta if beta is not None else y, h * w, c, eps,
            HAS_AFFINE=gamma is not None, BLOCK_HW=_TILE // bc, BLOCK_C=bc,
            num_warps=8)
    instance_norm.launches += 1
    if gamma is not None:
        instance_norm.affine_launches += 1
    return y


instance_norm.launches = 0
instance_norm.affine_launches = 0
