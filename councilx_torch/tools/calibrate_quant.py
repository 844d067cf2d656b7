"""Calibrate static W8A8 activation scales for quantized serving.

Counterpart of ``tools/calibrate_quant.py``: runs one member's serving
forward (encode_content -> decode) with its quantized convs in
``w8a8_calib`` mode over a folder of images (or seeded noise), each conv
folding its input's max |x| into a running absmax, and saves the stats as
the JAX package's flax-keyed ``quant_stats`` ``.npz``
(``enc_content/ResBlocks_0/ResBlock_1/Conv2dBlock_0/act_absmax`` ...):
either package serves from it.

    python -m councilx_torch.tools.calibrate_quant --config cfg.yaml \
        --checkpoint gen.pt --member 0 --input_folder imgs/ \
        [--num_batches 8] [--num_style 4] --out quant_stats.npz
    python -m councilx_torch.cli.serve --config cfg.yaml --checkpoint gen.pt \
        --member 0 --quant w8a8_static --calibration quant_stats.npz

The config's ``quant_scope`` decides which convs are calibrated; serve
with the same one. Each batch is decoded with ``--num_style`` style codes
drawn from a ``torch.Generator`` seeded with ``--seed``, so the decoder's
AdaIN-conditioned activations see the styles they will serve.
``--device`` defaults to the card.
"""

import argparse
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from councilx_torch.inference.translate import Translator
from councilx_torch.nn.generator import AdaINGen


def calibration_batches(cfg, input_folder, batch_size: int,
                        num_batches: int, seed: int
                        ) -> Iterator[np.ndarray]:
    """(B, H, W, 3) f32 batches in [-1, 1]: the folder's images in order
    (wrapping), resized and center-cropped as the CLIs do; or uniform
    noise from ``np.random.RandomState(seed)``."""
    hw = cfg.data.crop_image_height
    if input_folder is None:
        r = np.random.RandomState(seed)
        for _ in range(num_batches):
            yield r.uniform(-1, 1, (batch_size, hw, hw, 3)).astype(np.float32)
        return
    from councilx_torch.data.dataset import ImageFolderDataset
    from councilx_torch.data.ondevice import normalize_batch

    ds = ImageFolderDataset(input_folder, new_size=cfg.data.new_size, crop=hw)
    if not len(ds):
        raise SystemExit(f"no images in {input_folder}")
    for b in range(num_batches):
        arrs = np.stack([ds[(b * batch_size + i) % len(ds)]
                         for i in range(batch_size)])
        yield normalize_batch(torch.from_numpy(arrs)).numpy()


@torch.inference_mode()
def observe(translator: Translator, gen: AdaINGen, x, zs) -> None:
    """One calibration batch: x (B, H, W, 3) in [-1, 1] through the content
    encoder, then the decoder once per style code of zs (S, B, style_dim);
    ``gen``'s quantized convs (``w8a8_calib``) fold in their inputs' max
    |x|."""
    c = gen.encode_content(translator._to_device(x).to(translator.dtype))
    for z in torch.as_tensor(zs):
        gen.decode(c, translator._to_device(z).to(translator.dtype))


def calibrate(translator: Translator, gen: AdaINGen,
              batches: Iterable[np.ndarray], num_style: int,
              seed: int) -> Dict[str, torch.Tensor]:
    """Run :func:`observe` over ``batches``, ``num_style`` fresh codes per
    batch from a ``torch.Generator`` seeded with ``seed``; return the
    stats by port module name (``AdaINGen.quant_stats``)."""
    rng = torch.Generator().manual_seed(seed)
    style_dim = translator.cfg.gen.style_dim
    for x in batches:
        zs = torch.randn((num_style, x.shape[0], style_dim), generator=rng)
        observe(translator, gen, x, zs)
    return gen.quant_stats()


def main(argv=None) -> dict:
    from councilx_torch.ckpt.manager import (load_generator_state_dicts,
                                             save_params_npz)
    from councilx_torch.ckpt.torch_convert import port_quant_stats_to_tree
    from councilx_torch.config import load_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--member", type=int, default=0)
    p.add_argument("--direction", default="a2b", choices=["a2b", "b2a"])
    p.add_argument("--input_folder", default=None,
                   help="calibration images; omit for seeded noise")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_batches", type=int, default=8)
    p.add_argument("--num_style", type=int, default=4,
                   help="fresh style draws decoded per batch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="quant_stats.npz")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    # the translator refuses the calibration mode; its member is built in it
    cfg.quant = "none"
    tr = Translator(cfg, device=args.device)
    gen = tr.make_gen(quant="w8a8_calib")
    gen.load_state_dict(load_generator_state_dicts(
        args.checkpoint, cfg, args.direction)[args.member], strict=True)
    stats = calibrate(tr, gen, calibration_batches(
        cfg, args.input_folder, args.batch_size, args.num_batches,
        args.seed), args.num_style, args.seed)
    save_params_npz(args.out, port_quant_stats_to_tree(stats, cfg))
    maxima = np.array([float(v) for v in stats.values()])
    images = args.batch_size * args.num_batches
    print(f"calibrated {maxima.size} conv scales over {images} images x "
          f"{args.num_style} styles -> {args.out} (absmax range "
          f"[{maxima.min():.3g}, {maxima.max():.3g}])", flush=True)
    return {"convs": int(maxima.size), "images": images, "out": args.out,
            "absmax_min": float(maxima.min()),
            "absmax_max": float(maxima.max())}


if __name__ == "__main__":
    main()
