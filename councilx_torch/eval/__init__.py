"""Quality-metric evaluation (FID / KID): InceptionV3 pool3 features and
the Fréchet and kernel distances. Counterpart of ``councilx/eval``."""

from councilx_torch.eval.metrics import (  # noqa: F401
    frechet_distance,
    gaussian_stats,
    kid_from_features,
)
