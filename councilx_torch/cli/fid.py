"""FID/KID between two image folders, the port's counterpart of
``tools/fid.py``:

    python -m councilx_torch.cli.fid PATH_A PATH_B --weights inception.npz \\
        [--kid] [--device cuda]

The pytorch-fid protocol: InceptionV3 pool3 features at 299px bilinear,
Fréchet distance in float64. ``--weights`` is the JAX tool's Inception
``.npz`` (``tools/convert_inception_pt.py``) or a torchvision /
pytorch-fid ``.pt``/``.pth`` state dict. Without it the tool refuses to
print an FID (random-weight numbers compare with nothing) unless
``--allow-random`` is passed for smoke testing. ``--device`` defaults to
the card. Prints one JSON line: ``{"fid", "n_a", "n_b"[, "kid_mean",
"kid_std"]}``.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("folder_a")
    ap.add_argument("folder_b")
    ap.add_argument("--weights", default=None,
                    help=".npz from tools/convert_inception_pt.py, or a "
                         "torchvision/pytorch-fid .pt/.pth state dict")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--kid", action="store_true", help="also compute KID")
    ap.add_argument("--kid-subset-size", type=int, default=1000)
    ap.add_argument("--allow-random", action="store_true",
                    help="permit random-weight features (smoke tests only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from councilx_torch.eval.features import folder_features
    from councilx_torch.eval.inception import MissingWeights, make_inception
    from councilx_torch.eval.metrics import (fid_from_features,
                                             kid_from_features)

    try:
        model = make_inception(args.weights, args.device, args.allow_random)
    except MissingWeights:
        ap.error("--weights required (or --allow-random for smoke tests)")
    fa = folder_features(args.folder_a, model, args.batch_size)
    fb = folder_features(args.folder_b, model, args.batch_size)

    out = {"fid": fid_from_features(fa, fb),
           "n_a": int(fa.shape[0]), "n_b": int(fb.shape[0])}
    if args.kid:
        kid_mean, kid_std = kid_from_features(
            fa, fb, subset_size=args.kid_subset_size)
        out["kid_mean"] = kid_mean
        out["kid_std"] = kid_std
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
