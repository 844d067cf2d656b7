"""Adversarial losses (reference networks.py::MsImageDis.calc_dis_loss /
calc_gen_loss).

Counterpart of ``councilx/losses/gan.py``. LSGAN (the shipped configs'
gan_type):
  dis: sum over scales of mean(D(fake)^2) + mean((D(real) - 1)^2)
  gen: sum over scales of mean((D(fake) - 1)^2)
NSGAN (MUNIT option): sigmoid + BCE against 0/1. Each function takes the
list of per-scale logit maps the discriminator returns and reduces in f32.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def _bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    # BCE(sigmoid(x), t) == softplus(x) - t * x, elementwise mean
    return torch.mean(F.softplus(logits) - target * logits)


def gan_dis_loss(fake_outs: List[torch.Tensor], real_outs: List[torch.Tensor],
                 gan_type: str = "lsgan") -> torch.Tensor:
    """Discriminator loss over the scale pyramid. The caller detaches the
    fakes (the reference uses .detach())."""
    loss = 0.0
    for f, r in zip(fake_outs, real_outs):
        f, r = f.float(), r.float()
        if gan_type == "lsgan":
            loss = loss + torch.mean(f ** 2) + torch.mean((r - 1.0) ** 2)
        elif gan_type == "nsgan":
            loss = loss + _bce_logits(f, 0.0) + _bce_logits(r, 1.0)
        else:
            raise ValueError(f"unsupported gan_type: {gan_type}")
    return loss


def gan_gen_loss(fake_outs: List[torch.Tensor],
                 gan_type: str = "lsgan") -> torch.Tensor:
    """Generator-side adversarial loss over the scale pyramid."""
    loss = 0.0
    for f in fake_outs:
        f = f.float()
        if gan_type == "lsgan":
            loss = loss + torch.mean((f - 1.0) ** 2)
        elif gan_type == "nsgan":
            loss = loss + _bce_logits(f, 1.0)
        else:
            raise ValueError(f"unsupported gan_type: {gan_type}")
    return loss
