"""Focus-mask losses (reference: trainer_council.py focus/mask loss block).

Counterpart of ``councilx/losses/focus.py``: the generator's extra alpha
channel becomes a mask in [0, 1]; these push it to be small, binary and
(optionally) smooth. All in f32. mask: (..., H, W, 1).
"""

from __future__ import annotations

import torch


def mask_size_loss(mask: torch.Tensor) -> torch.Tensor:
    """mean(mask) -- penalize editing pixels at all."""
    return torch.mean(mask.float())


def mask_binary_loss(mask: torch.Tensor) -> torch.Tensor:
    """mean(mask * (1 - mask)) -- zero iff the mask is exactly binary."""
    m = mask.float()
    return torch.mean(m * (1.0 - m))


def mask_tv_loss(mask: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation on the mask (mean |grad mask|)."""
    m = mask.float()
    dh = torch.abs(m[..., 1:, :, :] - m[..., :-1, :, :])
    dw = torch.abs(m[..., :, 1:, :] - m[..., :, :-1, :])
    return torch.mean(dh) + torch.mean(dw)
