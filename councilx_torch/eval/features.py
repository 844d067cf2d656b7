"""Batched feature extraction for FID/KID.

Counterpart of ``councilx/eval/features.py``. PIL-exact preprocessing
(bilinear resize to 299, [-1, 1] normalize) matching pytorch-fid's input
convention, on the host as in the JAX package (quality evals bypass the
device augment); the features on the Inception module's device.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from councilx_torch.data.dataset import list_images


def u8_to_inception_inputs(u8: np.ndarray, size: int = 299) -> np.ndarray:
    """(B,H,W,3) uint8 -> (B,size,size,3) float32 in [-1,1], PIL bilinear —
    the single array-level home of the pytorch-fid input convention (the
    file-based iter_image_batches below applies the identical transform to
    PIL images; keep the two in lockstep)."""
    from PIL import Image

    out: List[np.ndarray] = []
    for row in np.asarray(u8):
        img = Image.fromarray(row).resize((size, size), Image.BILINEAR)
        out.append(np.asarray(img, dtype=np.float32) / 127.5 - 1.0)
    return np.stack(out)


def iter_image_batches(folder: str, batch_size: int = 32,
                       size: int = 299) -> Iterable[np.ndarray]:
    """Yield (B, size, size, 3) float32 batches in [-1, 1], PIL-resized, of
    every image under ``folder`` in sorted path order."""
    from PIL import Image

    paths = list_images(folder)
    if not paths:
        raise FileNotFoundError(f"no images under {folder}")
    batch: List[np.ndarray] = []
    for p in paths:
        img = Image.open(p).convert("RGB").resize((size, size),
                                                  Image.BILINEAR)
        batch.append(np.asarray(img, dtype=np.float32) / 127.5 - 1.0)
        if len(batch) == batch_size:
            yield np.stack(batch)
            batch = []
    if batch:
        yield np.stack(batch)


def extract_features(fn: Callable, batches: Iterable[np.ndarray],
                     pad_batch: Optional[int] = None) -> np.ndarray:
    """Run ``fn``, a (B,H,W,3) -> (B,D) feature module such as
    ``InceptionV3Features``, over host batches -> (N, D) float32 numpy.

    Each batch is copied to the module's device. A ragged final batch is
    zero-padded to ``pad_batch``, so the device sees one batch size, and
    the padding rows are dropped after."""
    device = next(fn.parameters()).device
    feats: List[np.ndarray] = []
    for b in batches:
        n = b.shape[0]
        if pad_batch and n < pad_batch:
            b = np.concatenate(
                [b, np.zeros((pad_batch - n,) + b.shape[1:], b.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(b))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        feats.append(fn(x)[:n].detach().float().cpu().numpy())
    return np.concatenate(feats)


def folder_features(folder: str, model, batch_size: int = 32) -> np.ndarray:
    """(N, 2048) Inception features of every image in a folder."""
    return extract_features(model, iter_image_batches(folder, batch_size),
                            pad_batch=batch_size)
