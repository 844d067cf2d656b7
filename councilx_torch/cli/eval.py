"""One-command checkpoint -> FID/KID evaluation, the port's counterpart of
``councilx/cli/eval.py``:

    python -m councilx_torch.cli.eval --config configs/<run>.yaml \\
        --checkpoint outputs/<run>/checkpoints --input_folder testA/ \\
        --target_folder testB/ --weights inception.npz [--kid] \\
        [--member 0 | --member all] [--device cuda]

Translates every image in ``--input_folder`` with the checkpointed
generator (in batches of ``--batch_size``; the tail batch padded with
copies of its last image, so the kernels see one batch size), then scores
the translations against ``--target_folder`` with InceptionV3 pool3
features (pytorch-fid protocol: 299px PIL-bilinear, Fréchet in float64).
``--member all`` is the paper's best-member protocol: every member
translates each batch in one call, and the JSON gains ``fid_per_member``,
``best_member`` (the argmin) and, with ``--kid``, ``kid_per_member``.

``--checkpoint``: a training snapshot of the port (a ``step_XXXXXXXX``
directory, or the ``checkpoints/`` directory above it: the newest), a
JAX-package ``.npz`` generator export or a reference ``.pt``
(``ckpt/manager.py::load_generator_state_dicts``). ``--weights``: the JAX
tool's Inception ``.npz`` (``tools/convert_inception_pt.py``) or a
torchvision / pytorch-fid ``.pt``/``.pth`` state dict; ``--allow-random``
takes random weights instead (smoke tests only). z codes come from a
``torch.Generator`` seeded with ``--seed`` (other numbers than the JAX
CLI's ``jax.random`` stream). Features are computed from the translated
uint8 arrays directly — the same as writing lossless PNGs and reading them
back; ``--save_translations DIR`` also keeps the images. ``--device``
defaults to the card. Prints one JSON line with the JAX CLI's keys.
"""

import argparse
import json
import os

import numpy as np
import torch


def _batches(ds, batch_size: int):
    """(indices, uint8 batch padded to batch_size with copies of its last
    image) over the dataset, in order."""
    for start in range(0, len(ds), batch_size):
        idxs = list(range(start, min(start + batch_size, len(ds))))
        arrs = np.stack([ds[i] for i in idxs])
        pad = batch_size - arrs.shape[0]
        if pad:
            arrs = np.concatenate([arrs, np.repeat(arrs[-1:], pad, axis=0)])
        yield idxs, arrs


def _save(save_dir: str, ds, idxs, u8) -> None:
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    for j, i in enumerate(idxs):
        base = os.path.splitext(os.path.basename(ds.paths[i]))[0]
        Image.fromarray(u8[j]).save(os.path.join(save_dir, f"{base}.png"))


def translated_feature_batches(translator, gens, ds, member: int, rng,
                               batch_size: int, save_dir=None):
    """Yield 299px [-1,1] Inception input batches of the input folder
    translated by ``member``, z per batch drawn from ``rng`` (a
    ``torch.Generator``)."""
    from councilx_torch.data.ondevice import normalize_batch
    from councilx_torch.eval.features import u8_to_inception_inputs

    for idxs, arrs in _batches(ds, batch_size):
        x = normalize_batch(torch.from_numpy(arrs))
        u8 = translator.translate_u8(gens, x, rng=rng,
                                     member=member)[:len(idxs)]
        if save_dir:
            _save(save_dir, ds, idxs, u8)
        yield u8_to_inception_inputs(u8)


def per_member_features(translator, gens, ds, rng, batch_size: int, model,
                        save_dir=None):
    """Inception features of every member's translations in one pass.

    The dataset is read once and each batch is translated by all members
    in one ``Translator.translate_all_members`` call, each member with its
    own style z ((N, batch_size, S) per batch from ``rng``); only the
    Inception passes multiply with the council size. Returns a list of
    (n_images, 2048) arrays indexed by member."""
    from councilx_torch.data.ondevice import normalize_batch
    from councilx_torch.eval.features import (extract_features,
                                              u8_to_inception_inputs)
    from councilx_torch.inference.translate import _u8_from_unit

    feats = [[] for _ in gens]
    for idxs, arrs in _batches(ds, batch_size):
        x = normalize_batch(torch.from_numpy(arrs))
        out, _ = translator.translate_all_members(gens, x, rng=rng)
        u8 = _u8_from_unit(out).cpu().numpy()[:, :len(idxs)]
        for m in range(len(gens)):
            if save_dir:
                _save(os.path.join(save_dir, f"m{m}"), ds, idxs, u8[m])
            feats[m].append(extract_features(
                model, [u8_to_inception_inputs(u8[m])],
                pad_batch=batch_size))
    return [np.concatenate(f) for f in feats]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--input_folder", required=True)
    ap.add_argument("--target_folder", required=True)
    ap.add_argument("--weights", default=None,
                    help="InceptionV3 .npz (tools/convert_inception_pt.py) "
                         "or torchvision/pytorch-fid .pt/.pth state dict")
    ap.add_argument("--allow-random", action="store_true",
                    help="permit random Inception weights (smoke tests only)")
    ap.add_argument("--kid", action="store_true", help="also compute KID")
    ap.add_argument("--kid-subset-size", type=int, default=1000)
    ap.add_argument("--member", default="0",
                    help="council member index, or 'all' for the paper's "
                         "best-member protocol (per-member FID/KID in one "
                         "run + the argmin)")
    ap.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--feature_batch_size", type=int, default=32)
    ap.add_argument("--save_translations", default=None,
                    help="also write the translated images here (png)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from councilx_torch.ckpt.manager import load_generator_state_dicts
    from councilx_torch.config import load_config
    from councilx_torch.data.dataset import ImageFolderDataset
    from councilx_torch.eval.features import (extract_features,
                                              folder_features)
    from councilx_torch.eval.inception import MissingWeights, make_inception
    from councilx_torch.eval.metrics import (fid_from_features,
                                             kid_from_features)
    from councilx_torch.inference.translate import Translator

    try:
        model = make_inception(args.weights, args.device, args.allow_random)
    except MissingWeights:
        ap.error("--weights required (or --allow-random for smoke tests)")

    cfg = load_config(args.config)
    translator = Translator(cfg, device=args.device)
    gens = translator.load_members(load_generator_state_dicts(
        args.checkpoint, cfg, args.direction))
    ds = ImageFolderDataset(args.input_folder, new_size=cfg.data.new_size,
                            crop=cfg.data.crop_image_height)
    f_target = folder_features(args.target_folder, model,
                               args.feature_batch_size)
    rng = torch.Generator().manual_seed(args.seed)

    if args.member == "all":
        # paper protocol: score every member, report the best (min FID)
        member_feats = per_member_features(
            translator, gens, ds, rng, args.batch_size, model,
            save_dir=args.save_translations)
        fids = [fid_from_features(f, f_target) for f in member_feats]
        best = min(range(len(fids)), key=lambda m: fids[m])
        out = {"fid": fids[best], "fid_per_member": fids,
               "best_member": best,
               "n_translated": int(member_feats[0].shape[0]),
               "n_target": int(f_target.shape[0]),
               "member": "all", "direction": args.direction,
               "checkpoint": args.checkpoint}
        if args.kid:
            out["kid_per_member"] = [
                kid_from_features(f, f_target,
                                  subset_size=args.kid_subset_size)
                for f in member_feats]
            out["kid"] = out["kid_per_member"][best]
        print(json.dumps(out), flush=True)
        return out

    member = int(args.member)
    f_trans = extract_features(
        model,
        translated_feature_batches(translator, gens, ds, member, rng,
                                   args.batch_size,
                                   save_dir=args.save_translations),
        pad_batch=args.batch_size)
    out = {"fid": fid_from_features(f_trans, f_target),
           "n_translated": int(f_trans.shape[0]),
           "n_target": int(f_target.shape[0]),
           "member": member, "direction": args.direction,
           "checkpoint": args.checkpoint}
    if args.kid:
        out["kid"] = kid_from_features(f_trans, f_target,
                                       subset_size=args.kid_subset_size)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
