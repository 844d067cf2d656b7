"""Serving preprocessing (counterpart of
``councilx/data/dataset.py::resize_crop_image``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def resize_crop_image(img, new_size: int, crop: Optional[int] = None
                      ) -> np.ndarray:
    """Opened PIL image -> shorter-side resize (bilinear,
    torchvision.Resize semantics) -> center crop -> HWC uint8."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    if min(w, h) != new_size:
        if w <= h:
            nw, nh = new_size, max(1, round(h * new_size / w))
        else:
            nw, nh = max(1, round(w * new_size / h)), new_size
        img = img.resize((nw, nh), Image.BILINEAR)
    c = crop if crop is not None else new_size
    w, h = img.size
    left = (w - c) // 2
    top = (h - c) // 2
    img = img.crop((left, top, left + c, top + c))
    return np.asarray(img, dtype=np.uint8)
