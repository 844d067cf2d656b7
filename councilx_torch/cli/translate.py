"""Folder translation CLI of the port, mirroring the reference
test_on_folder.py and ``councilx/cli/translate.py``:

    python -m councilx_torch.cli.translate --config configs/<run>.yaml \\
        --checkpoint outputs/<run>/checkpoints --input_folder in/ \\
        --output_folder out/ [--seed 1] [--num_style 1] [--member 0|all] \\
        [--direction a2b] [--batch_size 8] [--style_image img.jpg] \\
        [--device cuda]

``--checkpoint``: a training snapshot of the port (a ``step_XXXXXXXX``
directory, or the ``checkpoints/`` directory above it: the newest), a
JAX-package ``.npz`` generator export or a reference ``.pt``. Images run
in batches of ``--batch_size`` (the last one padded with copies of its
last image, as the JAX CLI does) and are written as
``<name>[_m<member>][_s<style>].jpg``, the JAX CLI's names. z codes come
from a ``torch.Generator`` seeded with ``--seed`` (other numbers than the
JAX CLI's ``jax.random`` stream); ``--style_image`` takes each member's
style code from an example image instead. ``--device`` defaults to the
card. ``--data_parallel D`` splits each batch over the first D cards
(``ShardedTranslator``; ``--batch_size`` a multiple of D; ``--device cpu``:
the CPU, D times).
"""

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_folder", required=True)
    p.add_argument("--output_folder", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num_style", type=int, default=1,
                   help="style samples per input image")
    p.add_argument("--member", default="0",
                   help="council member index, or 'all'")
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--style_image", default=None,
                   help="style-guided mode: take the style code from this "
                        "example image instead of sampling z")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard each batch over this many devices (0 = one "
                        "device; batch_size must divide evenly)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.data_parallel > 1 and args.batch_size % args.data_parallel:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible "
                         f"by --data_parallel {args.data_parallel}")

    from PIL import Image

    from councilx_torch.ckpt.manager import load_generator_state_dicts
    from councilx_torch.config import load_config
    from councilx_torch.data.dataset import (ImageFolderDataset,
                                             _load_resize_crop)
    from councilx_torch.data.ondevice import normalize_batch
    from councilx_torch.inference.translate import (ShardedTranslator,
                                                    Translator)
    from councilx_torch.parallel.mesh import local_devices

    cfg = load_config(args.config)
    if args.data_parallel > 1:
        try:
            devices = local_devices(args.data_parallel, args.device)
        except ValueError as e:
            raise SystemExit(f"--data_parallel: {e}") from None
        translator = ShardedTranslator(cfg, devices)
    else:
        translator = Translator(cfg, device=args.device)
    gens = translator.load_members(load_generator_state_dicts(
        args.checkpoint, cfg, args.direction))
    os.makedirs(args.output_folder, exist_ok=True)
    members = (list(range(len(gens))) if args.member == "all"
               else [int(args.member)])
    crop = cfg.data.crop_image_height
    ds = ImageFolderDataset(args.input_folder, new_size=cfg.data.new_size,
                            crop=crop)

    style_z = None
    if args.style_image:
        arr = _load_resize_crop(args.style_image, cfg.data.new_size, crop)
        xs = normalize_batch(torch.from_numpy(arr[None]))
        # each member's style code of the example image: (1, S)
        style_z = {m: translator.encode_style(gens, xs, member=m)
                   for m in members}
        if args.num_style > 1:
            print("note: --style_image fixes the style; num_style ignored")
            args.num_style = 1

    rng = torch.Generator().manual_seed(args.seed)
    count = 0
    bs = args.batch_size
    for start in range(0, len(ds), bs):
        idxs = list(range(start, min(start + bs, len(ds))))
        arrs = np.stack([ds[i] for i in idxs])
        pad = bs - arrs.shape[0]
        if pad:     # the tail batch at the full size, as the JAX CLI
            arrs = np.concatenate([arrs, np.repeat(arrs[-1:], pad, axis=0)])
        x = normalize_batch(torch.from_numpy(arrs))
        for m in members:
            for s in range(args.num_style):
                z = (style_z[m].expand(x.shape[0], -1)
                     if style_z is not None else None)
                out_u8 = translator.translate_u8(gens, x, z=z, rng=rng,
                                                 member=m)
                for j, i in enumerate(idxs):
                    base = os.path.splitext(os.path.basename(ds.paths[i]))[0]
                    suffix = (f"_m{m}" if len(members) > 1 else "") + (
                        f"_s{s}" if args.num_style > 1 else "")
                    Image.fromarray(out_u8[j]).save(os.path.join(
                        args.output_folder, f"{base}{suffix}.jpg"))
        count += len(idxs)
    print(f"translated {count} images -> {args.output_folder}", flush=True)
    return count


if __name__ == "__main__":
    main()
