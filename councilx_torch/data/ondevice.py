"""Image preprocessing on the batch's device: normalize, crop, flip.

Counterpart of ``councilx/data/ondevice.py``. The host hands over
static-shape uint8 batches; the per-sample random crop and horizontal flip
and the [-1, 1] normalization run on the device, so only uint8 crosses the
host link (4x fewer bytes than f32).

The JAX package draws each row's crop and flip inside its jitted augment
from ``fold_in(rng, row_offset + i)``; no torch generator gives that
stream. So the function is split in two: :func:`draw_crops` draws each
row's ``(oy, ox, flip)`` on the host from a ``torch.Generator`` seeded by
(seed, step, stream, global row), so a resumed run draws exactly the crops
the uninterrupted one would, and a row's draw does not depend on which
process augments it; :func:`augment_batch` applies given crops and flips
as one gather on the device. Held bitwise against the JAX package with the
JAX draws injected (tests/test_torch_data.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def normalize_batch(batch_u8: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 HWC batch -> float in [-1, 1] (ToTensor + Normalize(.5, .5)),
    as the JAX package computes it: (x - 127.5) * (1 / 127.5) in f32."""
    x = (batch_u8.to(torch.float32) - 127.5) * (1.0 / 127.5)
    return x.to(dtype)


def row_seed(seed: int, step: int, stream: int, row: int) -> int:
    """The 63-bit seed of one row's draw, a hash of (seed, step, stream,
    global row) by ``np.random.SeedSequence``."""
    lo, hi = np.random.SeedSequence((seed, step, stream, row)).generate_state(
        2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def draw_crops(seed: int, step: int, stream: int, rows: Sequence[int],
               h: int, w: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """(3, len(rows)) int64 on the CPU: each row's crop offsets oy in
    [0, h - crop_h] and ox in [0, w - crop_w], and its flip (0 or 1), drawn
    from a ``torch.Generator`` seeded by :func:`row_seed`. ``stream``
    tells apart the draws of one step (the train loop's domain A is 0, B
    is 1); ``rows`` are global row indices."""
    out = torch.empty((3, len(rows)), dtype=torch.int64)
    g = torch.Generator()
    for i, r in enumerate(rows):
        g.manual_seed(row_seed(seed, step, stream, r))
        out[0, i] = torch.randint(0, h - crop_h + 1, (), generator=g)
        out[1, i] = torch.randint(0, w - crop_w + 1, (), generator=g)
        out[2, i] = torch.randint(0, 2, (), generator=g)
    return out


def augment_batch(batch_u8: torch.Tensor, crop_h: int, crop_w: int,
                  train: bool = True, dtype: torch.dtype = torch.float32,
                  crops: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, crop_h, crop_w, C) float in [-1, 1], on
    the batch's device.

    train=True: each row's crop at (oy, ox), mirrored where flip is set,
    from ``crops`` (3, B) int64 as :func:`draw_crops` gives them (on any
    device): one gather of the uint8 pixels, then the normalize.
    train=False: the center crop."""
    b, h, w, c = batch_u8.shape
    if not train:
        oy, ox = (h - crop_h) // 2, (w - crop_w) // 2
        return normalize_batch(batch_u8[:, oy:oy + crop_h, ox:ox + crop_w],
                               dtype)
    if crops is None or tuple(crops.shape) != (3, b):
        raise ValueError(f"augment_batch: train=True needs crops (3, {b}), "
                         f"got {None if crops is None else tuple(crops.shape)}")
    dev = batch_u8.device
    crops = crops.to(dev, non_blocking=True)
    oy, ox, flip = crops[0], crops[1], crops[2].bool()
    ar_h = torch.arange(crop_h, device=dev)
    ar_w = torch.arange(crop_w, device=dev)
    rows = oy[:, None] + ar_h                                   # (B, ch)
    cols = ox[:, None] + torch.where(flip[:, None], crop_w - 1 - ar_w,
                                     ar_w)                      # (B, cw)
    bi = torch.arange(b, device=dev)[:, None, None]
    return normalize_batch(batch_u8[bi, rows[:, :, None], cols[:, None, :]],
                           dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) float -> (..., out_h, out_w, C): bilinear with
    half-pixel centres, antialiased when shrinking, as
    ``jax.image.resize(method="bilinear")`` (not PIL-exact): training,
    and the Inception module's ``resize_input``."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
