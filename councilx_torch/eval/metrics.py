"""FID / KID metric math.

Counterpart of ``councilx/eval/metrics.py``, copied: the same numpy/scipy
code, so FID and KID on the same features equal the JAX package's (KID's
subsets are the same ``np.random.RandomState(seed)`` draws).

Standard definitions (Heusel et al. 2017; Binkowski et al. 2018), matching
the conventions of the public ``pytorch-fid`` / ``torch-fidelity`` tools the
Council-GAN paper's numbers were produced with:

  FID  = ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2})
  KID  = unbiased MMD^2 with kernel k(x, y) = (x.y / d + 1)^3, reported as
         the mean over independent subsets.

All math runs in float64 on host (numpy/scipy) — feature extraction is the
accelerator-heavy part and lives in eval/features.py / eval/inception.py.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)) in float64."""
    f = np.asarray(features, dtype=np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the FID formula).

    Uses scipy's matrix sqrt with the same eps-jitter retry as pytorch-fid
    so numbers are comparable with the standard tooling.
    """
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))

    def _sqrtm(m):
        out = linalg.sqrtm(m)  # scipy >= 1.17 returns just the matrix
        return out[0] if isinstance(out, tuple) else out

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = gaussian_stats(feats1)
    mu2, s2 = gaussian_stats(feats2)
    return frechet_distance(mu1, s1, mu2, s2)


def _poly_kernel(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    d = x.shape[1]
    return (x @ y.T / d + 1.0) ** 3


def _mmd2_unbiased(x: np.ndarray, y: np.ndarray) -> float:
    m, n = x.shape[0], y.shape[0]
    kxx = _poly_kernel(x, x)
    kyy = _poly_kernel(y, y)
    kxy = _poly_kernel(x, y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return float(sum_xx + sum_yy - 2.0 * sum_xy)


def kid_from_features(feats1: np.ndarray, feats2: np.ndarray,
                      n_subsets: int = 100, subset_size: int = 1000,
                      seed: int = 0) -> Tuple[float, float]:
    """Kernel Inception Distance -> (mean, std) over random subsets.

    Subset size is clamped to the smaller sample count (torch-fidelity
    convention)."""
    f1 = np.asarray(feats1, dtype=np.float64)
    f2 = np.asarray(feats2, dtype=np.float64)
    m = min(subset_size, f1.shape[0], f2.shape[0])
    if m < 2:
        raise ValueError("need at least 2 samples per side for KID")
    rng = np.random.RandomState(seed)
    vals = []
    for _ in range(n_subsets):
        i1 = rng.choice(f1.shape[0], m, replace=False)
        i2 = rng.choice(f2.shape[0], m, replace=False)
        vals.append(_mmd2_unbiased(f1[i1], f2[i2]))
    return float(np.mean(vals)), float(np.std(vals))
