"""Datasets: image folders, file lists and synthetic images.

Counterpart of ``councilx/data/dataset.py`` (reference data.py::
{ImageFolder, ImageFilelist, is_image_file, default_loader,
make_dataset}). Unpaired domains are plain folders of images (trainA/trainB,
testA/testB).

The host work is small and of one static shape: decode with PIL, resize the
shorter side to ``new_size`` (PIL bilinear, as torchvision.Resize), center
crop to a ``new_size`` square, return HWC uint8. The random crops and flips
of training run on the device (``councilx_torch/data/ondevice.py``).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".webp")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def list_images(root: str) -> List[str]:
    """The image files under ``root``, recursively, sorted."""
    paths = []
    for dirpath, _, filenames in os.walk(root):
        for fname in sorted(filenames):
            if is_image_file(fname):
                paths.append(os.path.join(dirpath, fname))
    return sorted(paths)


def resize_crop_image(img, new_size: int, crop: Optional[int] = None
                      ) -> np.ndarray:
    """Opened PIL image -> shorter-side resize (bilinear,
    torchvision.Resize semantics) -> center crop -> HWC uint8. The one
    preprocessing of the CLIs, the server (on request bytes) and the
    datasets (on paths)."""
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
    # a writable copy: torch.from_numpy takes it without a warning
    return np.array(img, dtype=np.uint8)


def _load_resize_crop(path: str, new_size: int, crop: Optional[int] = None
                      ) -> np.ndarray:
    """PIL decode from a path, then :func:`resize_crop_image`."""
    from PIL import Image

    with Image.open(path) as img:
        return resize_crop_image(img, new_size, crop)


class _PathDataset:
    """Images at ``paths``, each decoded by :func:`_load_resize_crop`."""

    paths: List[str]

    def __init__(self, new_size: int, crop: Optional[int],
                 return_paths: bool):
        self.new_size = new_size
        self.crop = crop
        self.return_paths = return_paths

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int):
        arr = _load_resize_crop(self.paths[idx], self.new_size, self.crop)
        if self.return_paths:
            return arr, self.paths[idx]
        return arr


class ImageFolderDataset(_PathDataset):
    """Every image under a folder (reference data.py::ImageFolder)."""

    def __init__(self, root: str, new_size: int,
                 crop: Optional[int] = None, return_paths: bool = False):
        super().__init__(new_size, crop, return_paths)
        self.root = root
        self.paths = list_images(root)
        if not self.paths:
            raise FileNotFoundError(f"no images found under {root}")


class ImageFilelistDataset(_PathDataset):
    """Image paths listed in a text file, one path relative to ``root`` per
    line, optionally followed by a label (reference data.py::
    ImageFilelist)."""

    def __init__(self, root: str, flist: str, new_size: int,
                 crop: Optional[int] = None, return_paths: bool = False):
        super().__init__(new_size, crop, return_paths)
        with open(flist) as f:
            rels = [line.strip().split()[0] for line in f if line.strip()]
        self.paths = [os.path.join(root, r) for r in rels]


class SyntheticImageDataset:
    """Deterministic synthetic uint8 images, shaped and typed as the folder
    datasets' (tests and smoke runs; no files)."""

    def __init__(self, size: int, new_size: int, seed: int = 0):
        self.size = size
        self.new_size = new_size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed + idx)
        return rng.randint(0, 256, size=(self.new_size, self.new_size, 3),
                           dtype=np.uint8)
