"""Sample-sheet image grids and the static HTML index of a run.

Counterpart of ``councilx/utils/images.py`` (reference utils.py::
{write_2images, __write_images, write_html}): torchvision-style grids
built on the host with numpy and saved with PIL; inputs are NHWC float in
[-1, 1] (or uint8).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from councilx_torch.inference.translate import denormalize_to_uint8


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """(K, H, W, C) uint8 -> one (gh, gw, C) uint8 grid image, ``nrow``
    images to a row."""
    k, h, w, c = images.shape
    ncol = min(nrow, k)
    nrows = (k + ncol - 1) // ncol
    grid = np.full((nrows * (h + padding) + padding,
                    ncol * (w + padding) + padding, c), pad_value,
                   dtype=np.uint8)
    for i in range(k):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(path: str, images: np.ndarray, nrow: int = 8) -> None:
    """images: NHWC float in [-1, 1] (or uint8) -> one grid image file."""
    from PIL import Image

    if images.dtype != np.uint8:
        images = denormalize_to_uint8(images)
    Image.fromarray(make_grid(images, nrow=nrow)).save(path)


def sample_sheet(x_in: np.ndarray, member_outputs: np.ndarray,
                 masks: Optional[np.ndarray] = None) -> np.ndarray:
    """The rows of a sample sheet as one NHWC float batch: the inputs, then
    one row per council member, then (focus) one row per member's mask
    drawn in [-1, 1]."""
    rows = [x_in] + [member_outputs[i] for i in range(member_outputs.shape[0])]
    if masks is not None:
        rows += [np.repeat(masks[i] * 2.0 - 1.0, 3, axis=-1)
                 for i in range(masks.shape[0])]
    return np.concatenate(rows, axis=0)


def write_sample_sheet(image_dir: str, name: str, x_in: np.ndarray,
                       member_outputs: np.ndarray,
                       masks: Optional[np.ndarray] = None) -> str:
    """``<image_dir>/<name>.jpg``: :func:`sample_sheet` as a grid with one
    row of ``len(x_in)`` images per input, member and mask row; -> its
    path."""
    path = os.path.join(image_dir, f"{name}.jpg")
    save_image_grid(path, sample_sheet(x_in, member_outputs, masks),
                    nrow=x_in.shape[0])
    return path


def write_html(html_path: str, image_dir: str, iterations: int,
               image_save_iter: int) -> None:
    """Static index of the saved sample sheets, newest first."""
    rel = os.path.basename(image_dir)
    rows = []
    for it in range(iterations, -1,
                    -image_save_iter if image_save_iter else -1):
        for name in (f"train_{it:08d}", f"test_{it:08d}"):
            if os.path.exists(os.path.join(image_dir, f"{name}.jpg")):
                rows.append(f"<h3>iteration {it} — {name}</h3>"
                            f'<img src="{rel}/{name}.jpg" /><br/>')
        if image_save_iter == 0:
            break
    html = ("<!DOCTYPE html><html><head><title>samples</title></head>"
            "<body>" + "\n".join(rows) + "</body></html>")
    with open(html_path, "w") as f:
        f.write(html)
